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
// What bounds it on the H100: two transcendentals (expf, log1pf) and one
// rsqrtf per ordered pair -- at E=243 and B=4096 that is 242M pair
// evaluations per step.  Device memory traffic is only 2 x B x E x 8 bytes.
//
// Design: one thread block per env; the env's E positions sit in shared
// memory (E x 8 bytes, about 2 KB at E=243), so every pair reads shared
// memory as a broadcast.  One thread per entity i loops over all j and keeps
// its force in registers: each pair is evaluated twice and no atomics are
// needed.  The Newton's-third-law triangle (each pair once) is a later
// speed-up.  The softplus is the stable form max(z,0) + log1p(exp(-|z|)), as
// in the TPU kernel.

#include <cuda_runtime.h>

__global__ void pairforce_sym_kernel(const float* __restrict__ pos,
                                     float* __restrict__ force, int E,
                                     float k, float invk, float cf,
                                     float dmin) {
  extern __shared__ float sh[];  // [E][2]
  const size_t base = (size_t)blockIdx.x * E * 2;
  for (int t = threadIdx.x; t < 2 * E; t += blockDim.x) sh[t] = pos[base + t];
  __syncthreads();

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const float xi = sh[2 * i], yi = sh[2 * i + 1];
    float fx = 0.f, fy = 0.f;
    for (int j = 0; j < E; ++j) {
      if (j == i) continue;
      const float dx = xi - sh[2 * j];
      const float dy = yi - sh[2 * j + 1];
      const float s = fmaxf(dx * dx + dy * dy, 1e-24f);
      const float r = rsqrtf(s);
      const float z = (dmin - s * r) * invk;
      const float pen = (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) * k;
      const float c = cf * pen * r;
      fx += c * dx;
      fy += c * dy;
    }
    force[base + 2 * i] = fx;
    force[base + 2 * i + 1] = fy;
  }
}

extern "C" int pairforce_sym_launch(const void* pos, void* force, int B, int E,
                                    float k, float invk, float cf, float dmin,
                                    void* stream) {
  if (B == 0 || E == 0) return 0;
  int threads = ((E + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)E * 2 * sizeof(float);
  pairforce_sym_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (float*)force, E, k, invk, cf, dmin);
  return (int)cudaGetLastError();
}
