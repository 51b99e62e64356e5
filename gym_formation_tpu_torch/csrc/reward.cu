// K7: Hausdorff and collision statistics of the formation_hd reward, in one
// sweep of the agent x vertex and agent x agent planes.
//
// Replaces gym_formation_tpu/ops/pallas/reward.py:hd_reward_stats_batched
// (its _kernel, the row-major layout of set_reward_impl("rowmajor")).  Same
// function as the plain version
// gym_formation_tpu_torch/ops/kernels/reward.py:hd_reward_stats_batched_plain.
// Per env b, with the agents c_i = a_i - mean(a) centred on their centroid
// and the ideal shape s_j:
//
//   haus2[b]    = max(max_i min_j |c_i - s_j|^2, max_j min_i |c_i - s_j|^2)
//   ncoll[b, i] = #{ j : |a_i - a_j|^2 < thresh^2 } - 1   (raw positions;
//                 the full sweep counts the self hit, which is taken off)
//
// The wrapper takes the one square root of haus2.
//
// What bounds it on the H100: the two N^2 sweeps, about 14 FP32 operations
// and one warp shuffle per agent-vertex-agent triple (59k pairs an env at
// N=243).  Device memory traffic is only 4 x B x N x 4 bytes in and
// B x (N + 1) x 4 out.
//
// Design: one thread block per env; raw agents, centred agents and the
// shape sit in shared memory.  The TPU kernel accumulates the column minima
// across its sequential row-tile grid; here the thread of agent i computes
// each distance |c_i - s_j|^2 once and feeds both minima.  The row minimum
// stays in the thread's register.  For the column minimum, each warp walks
// the vertices in tiles of 32, lane l on vertex (l + s) mod 32 at step s,
// and carries one running minimum per vertex that moves one lane down at
// every step (one shuffle a pair); after 32 steps lane l holds the warp's
// minimum of vertex (l + 31) mod 32, and one atomicMin on its bit pattern
// (non-negative floats order as unsigned ints) merges it into shared
// memory.  The collision count runs in the same loop.  As in K2, the
// count's squared distance is rounded step by step (rn_*), so counts equal
// the plain version's exactly and equal K2's on the same inputs; the
// centroid is K2's (block_centroid), so Hausdorff distances match K2's too.

#include "common.cuh"

__global__ void reward_rowmajor_kernel(const float* __restrict__ apos,
                                       const float* __restrict__ ishape,
                                       float* __restrict__ haus2,
                                       float* __restrict__ ncoll, int N,
                                       float thresh2) {
  extern __shared__ float sh[];
  float* rx = sh;          // raw agent x
  float* ry = sh + N;      // raw agent y
  float* cx = sh + 2 * N;  // centred agent x
  float* cy = sh + 3 * N;  // centred agent y
  float* sx = sh + 4 * N;  // shape x
  float* sy = sh + 5 * N;  // shape y
  unsigned* colmin = (unsigned*)(sh + 6 * N);  // bit patterns of the minima
  float* scratch = sh + 7 * N;
  const int b = blockIdx.x, lane = threadIdx.x & 31;
  const size_t base = (size_t)b * N * 2;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    rx[t] = apos[base + 2 * t];
    ry[t] = apos[base + 2 * t + 1];
    sx[t] = ishape[base + 2 * t];
    sy[t] = ishape[base + 2 * t + 1];
    colmin[t] = __float_as_uint(FLT_MAX);
  }
  __syncthreads();
  block_centroid(rx, ry, cx, cy, N, scratch);

  float worst = 0.f;  // squared distances are >= 0
  // every thread takes the same number of row passes, so that whole warps
  // take part in the shuffles; rows past N are dummies
  for (int row0 = 0; row0 < N; row0 += blockDim.x) {
    const int i = row0 + threadIdx.x;
    const bool real = i < N;
    const float ax = real ? cx[i] : 0.f, ay = real ? cy[i] : 0.f;
    const float qx = real ? rx[i] : 0.f, qy = real ? ry[i] : 0.f;
    float rmin = FLT_MAX;
    int cnt = 0;
    for (int j0 = 0; j0 < N; j0 += 32) {
      float acc = FLT_MAX;  // at step s: the minimum of vertex j0 + (lane + s) % 32
      for (int s = 0; s < 32; ++s) {
        if (s > 0) acc = __shfl_sync(0xffffffffu, acc, (lane + 1) & 31);
        const int j = j0 + ((lane + s) & 31);
        if (j < N) {
          const float dx = ax - sx[j], dy = ay - sy[j];
          const float d2 = dx * dx + dy * dy;
          rmin = fminf(rmin, d2);
          if (real) acc = fminf(acc, d2);
          const float e2 = rn_sq2(rn_sub(qx, rx[j]), rn_sub(qy, ry[j]));
          cnt += e2 < thresh2;
        }
      }
      const int jc = j0 + ((lane + 31) & 31);
      if (jc < N) atomicMin(&colmin[jc], __float_as_uint(acc));
    }
    if (real) {
      worst = fmaxf(worst, rmin);
      ncoll[(size_t)b * N + i] = (float)(cnt - 1);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < N; t += blockDim.x)
    worst = fmaxf(worst, __uint_as_float(colmin[t]));
  const float h2 = block_reduce(worst, scratch, true);
  if (threadIdx.x == 0) haus2[b] = h2;
}

extern "C" int reward_launch(const void* apos, const void* ishape, void* haus2,
                             void* ncoll, int B, int N, float thresh2,
                             void* stream) {
  if (B == 0 || N == 0) return 0;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = ((size_t)7 * N + 32) * sizeof(float);
  reward_rowmajor_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)apos, (const float*)ishape, (float*)haus2, (float*)ncoll,
      N, thresh2);
  return (int)cudaGetLastError();
}
