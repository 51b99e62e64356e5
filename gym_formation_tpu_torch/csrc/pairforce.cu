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
// What bounds it on the H100: instruction throughput.  Each unordered pair is
// one evaluation of about 42 SASS instructions in the loop of two full
// tiles (three special-function results: rsqrt, ex2, lg2; two shared float4
// loads; two shuffles; the rest FP32), so at E=246 and B=4096 the 123M pairs
// a call are about 162M warp instructions, 0.155 ms at one instruction a
// clock on each of the 132 x 4 schedulers; the loads take the shared-memory
// pipe about 0.12 ms beside it.  Device memory traffic is only
// 2 x B x E x 8 bytes and 4 x E floats of per-entity data.
//
// Design: one thread block per env, pair_sweep (common.cuh): each unordered
// pair is evaluated once, in tiles of 32 entities taken in rounds, and its
// term goes to both sides, f_ji = -f_ij up to each side's own weight.  The
// TPU kernel streams a static [Ep, Ep] pair table (the mask times the mass
// ratio) and a [Ep, Ep] table of contact radii through VMEM; here each
// entity is two float4s in shared memory (contact_entity, common.cuh),
//
//   P = (x, y, size, 1/m),  Q = (A, B, movable * collide, collide)
//   A = collide * (movable ? m : 0),  B = collide * (movable ? 0 : 1),
//
// so the weight of the pair's term on a is Q_a.z * (A_b * (1/m_a) + B_b)
// (contact_weight, shared with K8),
// which is collide_a collide_b movable_a (movable_b ? m_b / m_a : 1): the
// mass ratio rounds twice where the plain version's f64 table rounds once.
// The symmetric part, cf * pen * rsqrt(s), is computed once a pair
// (contact_coef: rsqrt of the squared distance clamped at 1e-24, the plain
// version's 1e-12 distance clamp, d = s * rsqrt(s), and the softplus by ex2
// and lg2); 1/k and the 1/m of each entity are formed once, outside the
// pair loop, so the loop has no IEEE division and no square root.  A tile
// pair in which no pair has a weight (no colliding entity on a side, or no
// movable one on either) is skipped.  12 floats an entity (P, Q and the two
// force sums) plus one flag word a tile: 12 KB at E=246; beyond 48 KB
// (E > 1024) the launcher opts in to more, up to the card's 227 KB
// (E <= 4800).
//
// Exactness: the pair sums go in an order fixed by E alone (no atomics), so
// two launches give the same bits.  They differ from the plain version's
// by rounding and by the softplus's ex2 and lg2 (contact_coef: at most
// about 4e-8 of force a pair at k = 1e-3, cf = 100).  At zero distance the
// pair's term is (finite) * 0.

#include "common.cuh"

struct DensePair {
  static constexpr int NC = 2;
  struct Ent {
    float4 p, q;
  };
  const float4* P;
  const float4* Q;
  const int* flags;  // per tile: bit 0 any colliding, bit 1 any movable and colliding
  float c_exp, c_log, cf;  // log2(e) / k, k ln 2, the contact force

  __device__ Ent load(int e) const { return {P[e], Q[e]}; }
  __device__ bool tiles(int I, int J) const {
    const int a = flags[I], b = flags[J];
    return (a & b & 1) && ((a | b) & 2);
  }
  __device__ void operator()(const Ent& a, const Ent& b, bool ok, float ta[2], float tb[2]) const {
    const float dx = a.p.x - b.p.x, dy = a.p.y - b.p.y;
    float g = contact_coef(dx, dy, a.p.z + b.p.z, c_exp, c_log, cf);
    if (!ok) g = 0.f;
    const float wa = contact_weight(a.p, a.q, b.q);
    const float wb = contact_weight(b.p, b.q, a.q);
    const float gx = g * dx, gy = g * dy;
    ta[0] = wa * gx;
    ta[1] = wa * gy;
    tb[0] = -(wb * gx);
    tb[1] = -(wb * gy);
  }
};

__host__ __device__ inline size_t pairforce_smem_bytes(int E) {
  const int T = (E + 31) / 32;
  return ((size_t)12 * 32 * T + T) * sizeof(float);
}

__global__ void pairforce_kernel(const float* __restrict__ pos,
                                 const float* __restrict__ ent,
                                 float* __restrict__ force, int E, float k,
                                 float cf) {
  extern __shared__ float4 sh4[];
  const int T = (E + 31) >> 5, Ep = T << 5;
  float4* P = sh4;
  float4* Q = sh4 + Ep;
  float* own = (float*)(sh4 + 2 * Ep);  // 2 x Ep
  float* react = own + 2 * Ep;          // 2 x Ep
  int* flags = (int*)(react + 2 * Ep);  // T
  const size_t base = (size_t)blockIdx.x * E * 2;
  for (int t = threadIdx.x; t < Ep; t += blockDim.x) {
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f), q = p;  // pads: finite, no weight
    if (t < E) contact_entity(ent, E, t, pos[base + 2 * t], pos[base + 2 * t + 1], p, q);
    P[t] = p;
    Q[t] = q;
    own[t] = own[Ep + t] = react[t] = react[Ep + t] = 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int I = threadIdx.x >> 5; I < T; I += blockDim.x >> 5) {
    const float4 q = Q[(I << 5) + lane];
    const unsigned cl = __ballot_sync(0xffffffffu, q.w != 0.f);
    const unsigned mc = __ballot_sync(0xffffffffu, q.z != 0.f);
    if (lane == 0) flags[I] = (cl ? 1 : 0) | (mc ? 2 : 0);
  }
  __syncthreads();

  pair_sweep(DensePair{P, Q, flags, 1.44269504f / k, k * 0.693147181f, cf}, E, own, react);

  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    force[base + 2 * i] = own[i] + react[i];
    force[base + 2 * i + 1] = own[Ep + i] + react[Ep + i];
  }
}

extern "C" int pairforce_launch(const void* pos, const void* ent, void* force,
                                int B, int E, float k, float cf, void* stream) {
  if (B == 0 || E == 0) return 0;
  int threads = ((E + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = pairforce_smem_bytes(E);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairforce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pairforce_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)ent, (float*)force, E, k, cf);
  return (int)cudaGetLastError();
}
