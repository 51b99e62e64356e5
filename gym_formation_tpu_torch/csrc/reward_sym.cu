// K2: Hausdorff and collision statistics of the formation_hd reward.
//
// Replaces gym_formation_tpu/ops/pallas/reward_sym.py:hd_reward_stats_sym.
// Same function as the plain version
// gym_formation_tpu_torch/ops/kernels/reward_sym.py:hd_reward_stats_sym_plain.
// Per env b, with the agents c_i = a_i - mean(a) centred on their centroid
// and the ideal shape s_j:
//
//   haus[b]     = sqrt(max(max_i min_j |c_i - s_j|^2, max_j min_i |c_i - s_j|^2))
//   ncoll[b, i] = #{ j != i : |a_i - a_j|^2 < thresh^2 }   (raw positions)
//
// What bounds it on the H100: instruction issue.  At N=243 an env has 59k
// (agent, vertex) distances and 29k unordered agent pairs, all plain FP32
// arithmetic; device memory traffic is only 4 x B x N x 4 bytes in and
// B x N x 4 out.
//
// Design: one block of 256 threads per env (hd_stats_tiles, common.cuh),
// four blocks an SM (at most 64 registers a thread: R = 16 spills 420 bytes
// to local memory, and still ran faster on the H100 than three blocks
// without spills), so that one block's loads, centroid and barriers overlap
// the others' tiles.  The raw agents, the centred agents and the shape sit
// in shared memory, padded with NaN to a multiple of the super-tile 16 R (a
// NaN distance is dropped by the minima and never counts as a collision),
// R = 2, 4, 8 or 16 by N, so that a small env does not pay for a large
// tile.  A thread owns an R x R register tile:
// each (agent, vertex) squared distance is computed once and feeds the
// thread's row and column minima (about 6 instructions), each unordered
// agent pair is tested once and a hit counts for both agents.  The minima
// and counts are merged once per tile row or column, by shuffles over the
// lanes that share it and then by shared atomicMin / atomicAdd on ints:
// exact in any order, so two launches give the same bits.  A block
// max-reduction gives haus, with one sqrtf on the reduced value (sqrt is
// monotone).
//
// The collision counts must match the plain version exactly, so the
// predicate's squared distance is rounded step by step (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract dx*dx + dy*dy into an FMA and
// move pairs that sit on the threshold.  d^2 is compared with thresh^2, as
// in the TPU kernel.
//
// Masked form (mask != NULL): the block of an env whose mask byte is 0
// copies that env's rows of the fallback (haus_fb, ncoll_fb) and returns
// without computing.  The fused rollout recomputes the statistics only for
// envs that auto-reset, and launches this every step without asking the
// host whether any did.

#include "common.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(HD_THREADS, 4)
    reward_sym_kernel(const float2* __restrict__ apos, const float2* __restrict__ ishape,
                      const unsigned char* __restrict__ mask, const float* __restrict__ haus_fb,
                      const float* __restrict__ ncoll_fb, float* __restrict__ haus,
                      float* __restrict__ ncoll, int N, int Np, float thresh2) {
  const int b = blockIdx.x;
  if (mask != nullptr && !mask[b]) {  // uniform per block: no sync skipped
    for (int t = threadIdx.x; t < N; t += blockDim.x)
      ncoll[(size_t)b * N + t] = ncoll_fb[(size_t)b * N + t];
    if (threadIdx.x == 0) haus[b] = haus_fb[b];
    return;
  }
  // shared words: raw x, y, centred x, y, shape x, y, rmin, cmin, cnt (Np
  // each) and 32 of scratch
  extern __shared__ float sh[];
  float* rx = sh;           // raw agent x
  float* ry = sh + Np;      // raw agent y
  float* cx = sh + 2 * Np;  // centred agent x
  float* cy = sh + 3 * Np;  // centred agent y
  float* sx = sh + 4 * Np;  // shape x
  float* sy = sh + 5 * Np;  // shape y
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
cudaError_t launch(const void* apos, const void* ishape, const void* mask, const void* haus_fb,
                   const void* ncoll_fb, void* haus, void* ncoll, int B, int N, int smem, float thresh2,
                   cudaStream_t s) {
  const int Np = 16 * R * ((N + 16 * R - 1) / (16 * R));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(reward_sym_kernel<R>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  reward_sym_kernel<R><<<B, HD_THREADS, smem, s>>>(
      (const float2*)apos, (const float2*)ishape, (const unsigned char*)mask, (const float*)haus_fb,
      (const float*)ncoll_fb, (float*)haus, (float*)ncoll, N, Np, thresh2);
  return cudaGetLastError();
}

}  // namespace

// R, the side of a thread's tile (2, 4, 8 or 16), and smem, the block's
// shared memory bytes ((9 Np + 32) floats), are the wrapper's choice
// (ops/kernels/reward_sym.py: tile_side, _smem_bytes).
extern "C" int reward_sym_launch(const void* apos, const void* ishape, const void* mask,
                                 const void* haus_fb, const void* ncoll_fb, void* haus, void* ncoll,
                                 int B, int N, int R, int smem, float thresh2, void* stream) {
  if (B == 0 || N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 2: return (int)launch<2>(apos, ishape, mask, haus_fb, ncoll_fb, haus, ncoll, B, N, smem, thresh2, s);
    case 4: return (int)launch<4>(apos, ishape, mask, haus_fb, ncoll_fb, haus, ncoll, B, N, smem, thresh2, s);
    case 8: return (int)launch<8>(apos, ishape, mask, haus_fb, ncoll_fb, haus, ncoll, B, N, smem, thresh2, s);
    case 16: return (int)launch<16>(apos, ishape, mask, haus_fb, ncoll_fb, haus, ncoll, B, N, smem, thresh2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
