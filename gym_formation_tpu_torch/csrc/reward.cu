// K7: Hausdorff and collision statistics of the formation_hd reward, in one
// pass over the agent x vertex and agent x agent planes of each env.
//
// Replaces gym_formation_tpu/ops/pallas/reward.py:hd_reward_stats_batched
// (its _kernel, the row-major layout of set_reward_impl("rowmajor")).  Same
// function as the plain version
// gym_formation_tpu_torch/ops/kernels/reward.py:hd_reward_stats_batched_plain.
// Per env b, with the agents c_i = a_i - mean(a) centred on their centroid
// and the ideal shape s_j:
//
//   haus[b]     = sqrt(max(max_i min_j |c_i - s_j|^2, max_j min_i |c_i - s_j|^2))
//   ncoll[b, i] = #{ j : |a_i - a_j|^2 < thresh^2 } - 1   (raw positions)
//
// That is K2's function: the plain version counts the full sweep minus the
// self hit, the kernel counts j != i, with the same result.
//
// What bounds it on the H100: instruction issue, as K2.  At N=243 an env has
// 59k (agent, vertex) distances and 29k unordered agent pairs, all plain
// FP32 arithmetic; device memory traffic is only 4 x B x N x 4 bytes in and
// B x (N + 1) x 4 out.
//
// Design: K2's unmasked kernel.  One block of HD_THREADS = 256 threads an
// env, four blocks an SM; the env's raw agents and shape are loaded into
// shared memory padded with NaN to Np, a multiple of the super-tile 16 R (a
// NaN distance is dropped by the minima and never counts as a collision),
// and hd_stats_tiles<R> (common.cuh) computes each (agent, vertex) distance
// once and tests each unordered agent pair once in R x R register tiles, the
// minima and counts merged by shared integer atomics (exact in any order, so
// two launches give the same bits).  The counts now come from unordered
// pairs, as K2's do: a hit adds 1 to both agents, and the agent itself is
// never tested.  The wrapper picks R (2, 4, 8, 16 by N) and the shared
// memory with K2's rules, so K7 and K2 give the same bits on the same
// inputs.  The count's squared distance is rounded step by step (rn_*), so
// counts equal the plain version's exactly.

#include "common.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(HD_THREADS, 4)
    reward_rowmajor_kernel(const float2* __restrict__ apos, const float2* __restrict__ ishape,
                           float* __restrict__ haus, float* __restrict__ ncoll, int N, int Np,
                           float thresh2) {
  const int b = blockIdx.x;
  // shared words: raw x, y, centred x, y, shape x, y, rmin, cmin, cnt (Np
  // each) and 32 of scratch
  extern __shared__ float sh[];
  float* rx = sh;
  float* ry = sh + Np;
  float* cx = sh + 2 * Np;
  float* cy = sh + 3 * Np;
  float* sx = sh + 4 * Np;
  float* sy = sh + 5 * Np;
  int* rmin = (int*)(sh + 6 * Np);
  int* cmin = (int*)(sh + 7 * Np);
  int* cnt = (int*)(sh + 8 * Np);
  float* scratch = sh + 9 * Np;
  const float nan = __int_as_float(0x7fc00000);
  for (int t = threadIdx.x; t < Np; t += blockDim.x) {
    const bool in = t < N;
    const float2 p = in ? apos[(size_t)b * N + t] : make_float2(nan, nan);
    const float2 q = in ? ishape[(size_t)b * N + t] : make_float2(nan, nan);
    rx[t] = p.x;
    ry[t] = p.y;
    sx[t] = q.x;
    sy[t] = q.y;
  }
  __syncthreads();
  const float h = hd_stats_tiles<R>(rx, ry, sx, sy, cx, cy, rmin, cmin, cnt, N, Np, thresh2, scratch);
  for (int t = threadIdx.x; t < N; t += blockDim.x) ncoll[(size_t)b * N + t] = (float)cnt[t];
  if (threadIdx.x == 0) haus[b] = h;
}

template <int R>
cudaError_t launch(const void* apos, const void* ishape, void* haus, void* ncoll, int B, int N,
                   int smem, float thresh2, cudaStream_t s) {
  const int Np = 16 * R * ((N + 16 * R - 1) / (16 * R));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(reward_rowmajor_kernel<R>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  reward_rowmajor_kernel<R><<<B, HD_THREADS, smem, s>>>((const float2*)apos, (const float2*)ishape,
                                                        (float*)haus, (float*)ncoll, N, Np, thresh2);
  return cudaGetLastError();
}

}  // namespace

// R, the side of a thread's tile (2, 4, 8 or 16), and smem, the block's
// shared memory bytes ((9 Np + 32) floats), are the wrapper's choice, by
// K2's rules (ops/kernels/reward_sym.py: tile_side, _smem_bytes).
extern "C" int reward_launch(const void* apos, const void* ishape, void* haus, void* ncoll, int B,
                             int N, int R, int smem, float thresh2, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 2: return (int)launch<2>(apos, ishape, haus, ncoll, B, N, smem, thresh2, s);
    case 4: return (int)launch<4>(apos, ishape, haus, ncoll, B, N, smem, thresh2, s);
    case 8: return (int)launch<8>(apos, ishape, haus, ncoll, B, N, smem, thresh2, s);
    case 16: return (int)launch<16>(apos, ishape, haus, ncoll, B, N, smem, thresh2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
