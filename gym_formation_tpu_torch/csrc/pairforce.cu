// K6: soft-contact pair forces over any colliding subset (the dense kernel).
//
// Replaces gym_formation_tpu/ops/pallas/pairforce.py:collision_forces_batched
// (its _kernel).  Same physics as the plain version
// gym_formation_tpu_torch/ops/kernels/pairforce.py:collision_forces_batched_plain:
//
//   d    = |p_i - p_j|
//   pen  = k * softplus(-(d - (s_i + s_j)) / k)
//   F_i += pairc_ij * cf * pen / max(d, 1e-12) * (p_i - p_j)
//
// with pairc_ij = collide_i * collide_j * movable_i * (i != j)
//                 * (movable_j ? m_j / m_i : 1).
//
// What bounds it on the H100: per ordered pair one square root, one
// division, two transcendentals (expf, log1pf) and about 20 FP32 operations;
// at E=246 and B=4096 that is 248M pair evaluations a call.  Device memory
// traffic is only 2 x B x E x 8 bytes and 4 x E floats of per-entity data.
//
// Design: one thread block per env.  The TPU kernel streams a static
// [Ep, Ep] pair table (the mask times the mass ratio) and a [Ep, Ep] table
// of contact radii through VMEM; here the env's positions and four
// per-entity vectors (size, mass, movable, collide) sit in shared memory,
// 6 x E floats (about 6 KB at E=246), and each pair's coefficient is formed
// on the fly.  One thread per receiver i loops over every j and keeps its
// force in registers, so each pair is evaluated twice and no atomics are
// needed.  A receiver that is immovable or does not collide skips the loop.
// The softplus is the stable form max(z,0) + log1p(exp(-|z|)), as in the TPU
// kernel.  The distance is clamped at 1e-12 (nan_guard): at zero distance
// the pair's term is (finite) * 0.

#include <cuda_runtime.h>

__global__ void pairforce_kernel(const float* __restrict__ pos,
                                 const float* __restrict__ ent,
                                 float* __restrict__ force, int E, float k,
                                 float cf) {
  extern __shared__ float sh[];
  float* px = sh;          // positions x
  float* py = sh + E;      // positions y
  float* sz = sh + 2 * E;  // size
  float* ms = sh + 3 * E;  // mass
  float* mv = sh + 4 * E;  // movable (0 or 1)
  float* cl = sh + 5 * E;  // collide (0 or 1)
  const size_t base = (size_t)blockIdx.x * E * 2;
  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    px[t] = pos[base + 2 * t];
    py[t] = pos[base + 2 * t + 1];
    sz[t] = ent[t];
    ms[t] = ent[E + t];
    mv[t] = ent[2 * E + t];
    cl[t] = ent[3 * E + t];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    float fx = 0.f, fy = 0.f;
    if (mv[i] != 0.f && cl[i] != 0.f) {
      const float xi = px[i], yi = py[i], si = sz[i], mi = ms[i];
      for (int j = 0; j < E; ++j) {
        if (j == i || cl[j] == 0.f) continue;
        const float dx = xi - px[j];
        const float dy = yi - py[j];
        const float d = sqrtf(dx * dx + dy * dy);
        const float z = -(d - (si + sz[j])) / k;
        const float pen = (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) * k;
        const float ratio = mv[j] != 0.f ? ms[j] / mi : 1.f;
        const float c = ratio * (cf * pen / fmaxf(d, 1e-12f));
        fx += c * dx;
        fy += c * dy;
      }
    }
    force[base + 2 * i] = fx;
    force[base + 2 * i + 1] = fy;
  }
}

extern "C" int pairforce_launch(const void* pos, const void* ent, void* force,
                                int B, int E, float k, float cf, void* stream) {
  if (B == 0 || E == 0) return 0;
  int threads = ((E + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)6 * E * sizeof(float);
  pairforce_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)ent, (float*)force, E, k, cf);
  return (int)cudaGetLastError();
}
