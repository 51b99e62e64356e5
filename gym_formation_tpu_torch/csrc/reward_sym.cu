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
// in the TPU kernel.

#include <cuda_runtime.h>
#include <float.h>

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum (is_max = false) or max (is_max = true); every thread gets
// the result.  blockDim.x is a multiple of 32; scratch holds 32 floats.
__device__ float block_reduce(float v, float* scratch, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : (is_max ? -FLT_MAX : 0.f);
    w = is_max ? warp_max(w) : warp_sum(w);
    if (lane == 0) scratch[0] = w;
  }
  __syncthreads();
  return scratch[0];
}

__global__ void reward_sym_kernel(const float* __restrict__ apos,
                                  const float* __restrict__ ishape,
                                  float* __restrict__ haus,
                                  float* __restrict__ ncoll, int N,
                                  float thresh2) {
  extern __shared__ float sh[];
  float* rx = sh;          // raw agent x
  float* ry = sh + N;      // raw agent y
  float* cx = sh + 2 * N;  // centred agent x
  float* cy = sh + 3 * N;  // centred agent y
  float* sx = sh + 4 * N;  // shape x
  float* sy = sh + 5 * N;  // shape y
  float* scratch = sh + 6 * N;
  const size_t base = (size_t)blockIdx.x * N * 2;

  float px = 0.f, py = 0.f;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    const float x = apos[base + 2 * t], y = apos[base + 2 * t + 1];
    rx[t] = x;
    ry[t] = y;
    sx[t] = ishape[base + 2 * t];
    sy[t] = ishape[base + 2 * t + 1];
    px += x;
    py += y;
  }
  const float mx = block_reduce(px, scratch, false) / (float)N;
  const float my = block_reduce(py, scratch, false) / (float)N;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    cx[t] = rx[t] - mx;
    cy[t] = ry[t] - my;
  }
  __syncthreads();

  float worst = 0.f;  // squared distances are >= 0
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float ax = cx[i], ay = cy[i];  // agent i, centred
    const float vx = sx[i], vy = sy[i];  // vertex i
    const float qx = rx[i], qy = ry[i];  // agent i, raw
    float rmin = FLT_MAX, cmin = FLT_MAX;
    int cnt = 0;
    for (int j = 0; j < N; ++j) {
      const float dx = ax - sx[j], dy = ay - sy[j];
      rmin = fminf(rmin, dx * dx + dy * dy);
      const float ex = cx[j] - vx, ey = cy[j] - vy;
      cmin = fminf(cmin, ex * ex + ey * ey);
      const float gx = __fsub_rn(qx, rx[j]), gy = __fsub_rn(qy, ry[j]);
      const float d2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
      cnt += (j != i) && (d2 < thresh2);
    }
    worst = fmaxf(worst, fmaxf(rmin, cmin));
    ncoll[(size_t)blockIdx.x * N + i] = (float)cnt;
  }
  const float m = block_reduce(worst, scratch, true);
  if (threadIdx.x == 0) haus[blockIdx.x] = sqrtf(m);
}

extern "C" int reward_sym_launch(const void* apos, const void* ishape,
                                 void* haus, void* ncoll, int B, int N,
                                 float thresh2, void* stream) {
  if (B == 0 || N == 0) return 0;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = ((size_t)6 * N + 32) * sizeof(float);
  reward_sym_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)apos, (const float*)ishape, (float*)haus, (float*)ncoll, N,
      thresh2);
  return (int)cudaGetLastError();
}
