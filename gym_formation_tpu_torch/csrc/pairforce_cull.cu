// K8: soft-contact pair forces in Morton order, with far tile pairs culled.
//
// Replaces gym_formation_tpu/ops/pallas/pairforce_cull.py:collision_forces_culled
// (its _kernel).  Same function as the plain version
// gym_formation_tpu_torch/ops/kernels/pairforce_cull.py:collision_forces_culled_plain,
// which equals K6's up to the order of each receiver's sum.  With the
// entities of env b taken in the order order[b, :] (a stable sort by a
// 16-bit Morton key, computed by the wrapper):
//
//   d      = |p_i - p_j|
//   pen    = k * softplus(-(d - (s_i + s_j)) / k)   s = -1e4 where collide is 0
//   ratio  = wm_j * minv_i + om_j                   m_j/m_i if j movable, else 1
//   F_i    = mov_i * sum_j ratio * cf * pen / max(d, 1e-12) * (p_i - p_j)
//
// and the force of sorted entity i is written to force[b, order[b, i]].
//
// Culling is exact.  Entities sit in tiles of 32 consecutive sorted
// entities; a tile pair is skipped when the tiles' bounding boxes are
// farther apart than cutoff = 2 max(collide size) + 104 k on either axis.
// Every pair of a skipped tile pair then has z = -(d - dmin)/k < -104: its
// expf(z) is 0 or a subnormal, whose product with k (< 1) rounds to 0, so the
// pair would have added exactly 0 to the sum (no --use_fast_math, so no
// flush-to-zero changes this).  A sentinel size of -1e4 makes every pair of
// a non-colliding entity 0 the same way, and the self pair is 0 because
// p_i - p_i is.
//
// What bounds it on the H100: the pair evaluations that survive the cull,
// each a square root, a division, two transcendentals and about 20 FP32
// operations.  Per env at N=243 in a +-1 world the contact cutoff (0.164) is
// small beside the world, so most tile pairs are skipped; the work left is
// the near tiles.  Device memory traffic is B x E x (8 + 8 + 8) bytes
// (positions, order, forces).
//
// Design: one thread block per env.  The TPU kernel's predicate is an "any
// over 128 env lanes" test, since its lanes are envs; here the cull is per
// env.  The block gathers its env's positions and per-entity data (size,
// 1/m, movable x m, immovable) into shared memory in sorted order, one warp
// per tile computes its box (warp min and max), and each warp then owns a
// row tile: its lanes are the tile's 32 receivers, and for each column tile
// the whole warp tests the two boxes (the same test on every lane, so no
// divergence) and either skips the tile or loops over its 32 entities, read
// from shared memory as broadcasts.  Lane 0 counts the tile pairs it
// evaluates into tiles[b] when that pointer is given.

#include "common.cuh"

#define TILE 32

__global__ void pairforce_cull_kernel(const float* __restrict__ pos,
                                      const long long* __restrict__ order,
                                      const float* __restrict__ ent,
                                      float* __restrict__ force,
                                      int* __restrict__ tiles, int E, float k,
                                      float cf, float cutoff) {
  extern __shared__ float sh[];
  const int T = (E + TILE - 1) / TILE;
  float* px = sh;            // sorted positions x
  float* py = sh + E;        // sorted positions y
  float* sz = sh + 2 * E;    // size (sentinel where collide is 0)
  float* minv = sh + 3 * E;  // 1 / m
  float* wm = sh + 4 * E;    // m if movable, else 0
  float* om = sh + 5 * E;    // 1 if immovable, else 0
  float* box = sh + 6 * E;   // per tile: min x, max x, min y, max y
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t base = (size_t)b * E;
  for (int t = threadIdx.x; t < E; t += blockDim.x) {
    const int o = (int)order[base + t];
    px[t] = pos[2 * (base + o)];
    py[t] = pos[2 * (base + o) + 1];
    sz[t] = ent[o];
    minv[t] = ent[E + o];
    wm[t] = ent[2 * E + o];
    om[t] = ent[3 * E + o];
  }
  __syncthreads();

  for (int t = warp; t < T; t += nwarps) {
    const int e = t * TILE + lane;
    const bool real = e < E;
    const float x = real ? px[e] : FLT_MAX, y = real ? py[e] : FLT_MAX;
    const float x2 = real ? px[e] : -FLT_MAX, y2 = real ? py[e] : -FLT_MAX;
    const float lox = warp_min(x), hix = warp_max(x2);
    const float loy = warp_min(y), hiy = warp_max(y2);
    if (lane == 0) {
      box[4 * t] = lox;
      box[4 * t + 1] = hix;
      box[4 * t + 2] = loy;
      box[4 * t + 3] = hiy;
    }
  }
  __syncthreads();

  int done = 0;
  for (int rt = warp; rt < T; rt += nwarps) {
    const int i = rt * TILE + lane;
    const bool real = i < E;
    const float xi = real ? px[i] : 0.f, yi = real ? py[i] : 0.f;
    const float si = real ? sz[i] : 0.f, vi = real ? minv[i] : 0.f;
    const float rlox = box[4 * rt], rhix = box[4 * rt + 1];
    const float rloy = box[4 * rt + 2], rhiy = box[4 * rt + 3];
    float fx = 0.f, fy = 0.f;
    for (int ct = 0; ct < T; ++ct) {
      const bool near = box[4 * ct] <= rhix + cutoff && box[4 * ct + 1] >= rlox - cutoff &&
                        box[4 * ct + 2] <= rhiy + cutoff && box[4 * ct + 3] >= rloy - cutoff;
      if (!near) continue;
      ++done;
      const int jend = min(E, (ct + 1) * TILE);
      for (int j = ct * TILE; j < jend; ++j) {
        const float dx = xi - px[j];
        const float dy = yi - py[j];
        const float d = sqrtf(dx * dx + dy * dy);
        const float z = -(d - (si + sz[j])) / k;
        const float pen = (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) * k;
        const float ratio = wm[j] * vi + om[j];
        const float c = ratio * (cf * pen / fmaxf(d, 1e-12f));
        fx += c * dx;
        fy += c * dy;
      }
    }
    if (real) {
      const float mov = 1.f - om[i];
      const int o = (int)order[base + i];
      force[2 * (base + o)] = fx * mov;
      force[2 * (base + o) + 1] = fy * mov;
    }
  }
  if (tiles != nullptr && lane == 0 && done > 0) atomicAdd(&tiles[b], done);
}

extern "C" int pairforce_cull_launch(const void* pos, const void* order,
                                     const void* ent, void* force, void* tiles,
                                     int B, int E, float k, float cf,
                                     float cutoff, void* stream) {
  if (B == 0 || E == 0) return 0;
  int threads = ((E + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const int T = (E + TILE - 1) / TILE;
  const size_t smem = ((size_t)6 * E + 4 * T) * sizeof(float);
  pairforce_cull_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const long long*)order, (const float*)ent,
      (float*)force, (int*)tiles, E, k, cf, cutoff);
  return (int)cudaGetLastError();
}
