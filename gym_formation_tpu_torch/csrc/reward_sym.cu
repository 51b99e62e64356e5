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
// What bounds it on the H100: the N^2 squared-distance sweeps, three per
// env (agent row-min, vertex col-min, agent-agent collisions) -- about
// 3 x 59k pair evaluations per env at N=243, all plain FP32 arithmetic.
// Device memory traffic is only 4 x B x N x 4 bytes in and B x N x 4 out.
//
// Design: one thread block per env.  The raw agents, the centred agents and
// the shape sit in shared memory (6 x N floats, about 6 KB at N=243).
// Thread i computes agent i's row-min over the vertices, vertex i's col-min
// over the agents and agent i's collision count over all j != i, so no
// thread writes another's result.  A block max-reduction gives haus, with
// one sqrtf on the reduced value (sqrt is monotone).
//
// The collision counts must match the plain version exactly, so the
// predicate's squared distance is rounded step by step (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract dx*dx + dy*dy into an FMA and
// move pairs that sit on the threshold.  d^2 is compared with thresh^2, as
// in the TPU kernel.  The block body is hd_stats_block (common.cuh), which
// K3 shares.
//
// Masked form (mask != NULL): the block of an env whose mask byte is 0
// copies that env's rows of the fallback (haus_fb, ncoll_fb) and returns
// without computing.  The fused rollout recomputes the statistics only for
// envs that auto-reset, and launches this every step without asking the
// host whether any did.

#include "common.cuh"

__global__ void reward_sym_kernel(const float* __restrict__ apos,
                                  const float* __restrict__ ishape,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ haus_fb,
                                  const float* __restrict__ ncoll_fb,
                                  float* __restrict__ haus,
                                  float* __restrict__ ncoll, int N,
                                  float thresh2) {
  const int b = blockIdx.x;
  if (mask != nullptr && !mask[b]) {  // uniform per block: no sync skipped
    for (int t = threadIdx.x; t < N; t += blockDim.x)
      ncoll[(size_t)b * N + t] = ncoll_fb[(size_t)b * N + t];
    if (threadIdx.x == 0) haus[b] = haus_fb[b];
    return;
  }
  extern __shared__ float sh[];
  float* rx = sh;          // raw agent x
  float* ry = sh + N;      // raw agent y
  float* cx = sh + 2 * N;  // centred agent x
  float* cy = sh + 3 * N;  // centred agent y
  float* sx = sh + 4 * N;  // shape x
  float* sy = sh + 5 * N;  // shape y
  float* scratch = sh + 6 * N;
  const size_t base = (size_t)b * N * 2;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    rx[t] = apos[base + 2 * t];
    ry[t] = apos[base + 2 * t + 1];
    sx[t] = ishape[base + 2 * t];
    sy[t] = ishape[base + 2 * t + 1];
  }
  __syncthreads();
  const float h = hd_stats_block(rx, ry, sx, sy, cx, cy, N, thresh2, true,
                                 ncoll + (size_t)b * N, scratch);
  if (threadIdx.x == 0) haus[b] = h;
}

extern "C" int reward_sym_launch(const void* apos, const void* ishape,
                                 const void* mask, const void* haus_fb,
                                 const void* ncoll_fb, void* haus, void* ncoll,
                                 int B, int N, float thresh2, void* stream) {
  if (B == 0 || N == 0) return 0;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = ((size_t)6 * N + 32) * sizeof(float);
  reward_sym_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)apos, (const float*)ishape, (const unsigned char*)mask,
      (const float*)haus_fb, (const float*)ncoll_fb, (float*)haus,
      (float*)ncoll, N, thresh2);
  return (int)cudaGetLastError();
}
