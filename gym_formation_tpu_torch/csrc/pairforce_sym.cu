// K1: soft-contact pair forces over a uniform all-colliding subset.
//
// Replaces gym_formation_tpu/ops/pallas/pairforce_sym.py:collision_forces_sym
// (the _kernel_loop Pallas kernel).  Same physics as the plain version
// gym_formation_tpu_torch/ops/kernels/pairforce_sym.py:collision_forces_sym_plain:
//
//   s    = max(|p_i - p_j|^2, 1e-24)          (nan_guard)
//   pen  = k * softplus((dmin - sqrt(s)) / k)
//   F_i += cf * pen * rsqrt(s) * (p_i - p_j)   for every j != i
//
// What bounds it on the H100: instruction issue in the pair loop.  Each
// unordered pair is one evaluation of 36 SASS instructions in the loop of
// two full tiles, up to 44 in the masked and diagonal ones (three
// special-function results: rsqrt, ex2, lg2; two shared loads; two
// shuffles; the rest FP32), so at E=243 and B=4096 the 120.4M pairs a call
// are about 0.13 ms at one warp instruction a clock on each of the
// 132 x 4 schedulers.  Device memory traffic is only 2 x B x E x 8 bytes.
//
// Design: one thread block per env, pair_sweep with UniformPair (common.cuh),
// the pair sweep and functor K3 runs: each unordered pair is evaluated once
// (contact_coef: rsqrt of the squared distance clamped at 1e-24, the plain
// version's 1e-12 distance clamp, d = s * rsqrt(s), the softplus by
// ex2.approx and lg2.approx; no IEEE division or square root in the loop),
// +g d goes to the receiver and -g d to the partner.  Shared memory: x and
// y, and the sweep's own and react sums (x, y each), 6 floats an entity
// padded to tiles of 32: 6 KB at E=243; beyond 48 KB (E > 2048) the
// launcher opts in to more, up to 144 KB at the wrapper's limit of 6144.
//
// Exactness: the sums go in an order fixed by E alone (no atomics), so two
// launches give the same bits.  They differ from the plain version's by
// rounding and by the softplus's ex2 and lg2 (at most about 4e-8 of force a
// pair at the hd worlds' k = 1e-3, cf = 100).

#include "common.cuh"

__host__ __device__ inline size_t pairforce_sym_smem_bytes(int E) {
  return (size_t)6 * 32 * ((E + 31) / 32) * sizeof(float);
}

__global__ void __launch_bounds__(1024)
pairforce_sym_kernel(const float* __restrict__ pos, float* __restrict__ force, int E, float k,
                     float invk, float cf, float dmin) {
  extern __shared__ float sh[];
  const int Ep = ((E + 31) >> 5) << 5;
  float* x = sh;  // positions (Ep: pads at 0)
  float* y = x + Ep;
  float* own = y + Ep;          // the pair sweep's sums: 2 x Ep
  float* react = own + 2 * Ep;  // 2 x Ep
  const size_t base = (size_t)blockIdx.x * E * 2;
  for (int t = threadIdx.x; t < Ep; t += blockDim.x) {
    const bool real = t < E;
    x[t] = real ? pos[base + 2 * t] : 0.f;
    y[t] = real ? pos[base + 2 * t + 1] : 0.f;
    own[t] = own[Ep + t] = react[t] = react[Ep + t] = 0.f;
  }
  __syncthreads();

  pair_sweep(UniformPair<true, false>{x, y, invk * 1.44269504f, k * 0.693147181f, cf, dmin, 0.f},
             E, own, react);

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    force[base + 2 * i] = own[i] + react[i];
    force[base + 2 * i + 1] = own[Ep + i] + react[Ep + i];
  }
}

extern "C" int pairforce_sym_launch(const void* pos, void* force, int B, int E,
                                    float k, float invk, float cf, float dmin,
                                    void* stream) {
  if (B == 0 || E == 0) return 0;
  int threads = ((E + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = pairforce_sym_smem_bytes(E);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairforce_sym_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pairforce_sym_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (float*)force, E, k, invk, cf, dmin);
  return (int)cudaGetLastError();
}
