// K3: one formation_hd env step in one kernel -- the optional in-kernel
// BFS + ezpolicy policy, soft-contact pair forces, damped Euler with the
// speed clamp, and the reward statistics.
//
// Replaces gym_formation_tpu/ops/pallas/fused_step.py:fused_hd_step (the
// _kernel Pallas kernel, with its in-kernel policy
// gym_formation_tpu/models/bfs_planes.py:bfs_ez_planes).  Same function as
// the plain version
// gym_formation_tpu_torch/ops/kernels/fused_step.py:fused_hd_step_plain:
//
//   policy (L > 0):  a_i = act_scale * bfs_ez(positions, shape, ivel)_i
//                    else a_i = aforce_i
//   F_i   = sum_{j != i} cf * k * softplus((dmin - |d_ij|) / k) * d_ij / |d_ij| + a_i
//   v'_i  = v_i * keep + F_i * fscale, clamped to max_speed
//   p'_i  = p_i + v'_i * dt
//   stats on p (post = 0) or p' (post = 1): haus and per-agent counts, as K2
//
// What bounds it on the H100: instruction throughput in its two sweeps.  The
// pair sweep takes each unordered pair once, about 44 SASS instructions a
// pair in the loop of two full tiles with the collision count (rsqrt, ex2,
// lg2; two shared loads; three shuffles), 29k pairs per env at N=243; the
// statistics take one squared distance, two minima and one shuffle per
// (agent, vertex), 59k per env.  Then the policy, O(N) arithmetic but
// serial in its L levels (its top levels keep only a handful of threads
// busy).  Device memory traffic is about 11 x N x 4 bytes per env.
//
// Design: one thread block per env, one thread per agent (256 threads at
// N=243).
// - The policy builds its centroid pyramid bottom-up (one level per
//   __syncthreads), then walks the L levels top-down: one thread computes
//   all three members of a group and writes their velocities, the parents
//   of the next level, to shared memory.
// - The pair forces are pair_sweep (common.cuh) with K1's functor
//   (UniformPair, contact_coef): each unordered pair once, in tiles of 32
//   agents taken in rounds, its term added to one agent and subtracted from
//   the other, which
//   gets exactly the negated term (the same d and coefficient).  In pre mode
//   the collision count rides the same sweep as a third sum: the pair's
//   squared distance is rounded step by step (rn_sq2, symmetric bit for bit)
//   and a hit counts for both agents.  Post mode counts on the new positions
//   with a second, count-only sweep of the triangle.
// - The statistics (haus_rect) compute |c_i - s_j|^2 once per (agent i,
//   vertex j): the thread of agent i keeps its row minimum, and the
//   vertex's column minimum rotates through the warp as in K7 (lane l on
//   vertex (l + s) mod 32 at step s, the running minimum handed one lane
//   down each step), then merges across warps by atomicMin on its bit
//   pattern (non-negative floats order as unsigned ints): a minimum is exact
//   in any order.
// Shared memory: positions and new positions, the sweep's two sets of sums
// (3 each), the column minima and the shape, 13 floats per agent padded to
// tiles of 32; the centred agents, 2 per agent; the policy's pyramid and two
// parent-velocity buffers (about 6 x N): 21 KB at N=243.  Beyond 48 KB the
// launcher opts in to more, up to the card's 227 KB (N <= 3872).
//
// Exactness: the policy's comparisons flip an agent's action wholesale, so
// its arithmetic is spelled with rn_* (no contraction into fused
// multiply-adds), in the plain version's order, with its /3 as a division:
// on the card the policy's actions equal the plain version's bit for bit.
// The collision counts are exact (integers summed as floats).  Every sum
// goes in an order fixed by N alone, so two launches give the same bits;
// the forces differ from the plain version's by rounding and by the
// softplus's ex2 and lg2 (contact_coef), the Hausdorff distance by rounding.

#include <math.h>

#include "common.cuh"

// Member i of a group pairs vertex v with agent kSettledPerm[i][v] in the
// settled test (the reference orders its current shape as [others, self]).
__constant__ int kSettledPerm[3][3] = {{1, 2, 0}, {0, 2, 1}, {0, 1, 2}};

// Row offset of pyramid level k (3^k rows) in a plane of (3^L - 1) / 2 rows.
__device__ __forceinline__ int pyr_off(int k) {
  int p = 1;
  for (int i = 0; i < k; ++i) p *= 3;
  return (p - 1) / 2;
}

// One group's three members at one level of the BFS: Ax/Ay the members'
// centroids and Tx/Ty their targets, both centred on the group's; pv the
// group's commanded velocity.  Writes the members' velocities to out.
static __device__ void ez_group(const float Ax[3], const float Ay[3],
                                const float Tx[3], const float Ty[3], float pvx,
                                float pvy, float lvl, float* out_x, float* out_y) {
  float D[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int v = 0; v < 3; ++v) D[a][v] = rn_sq2(rn_sub(Ax[a], Tx[v]), rn_sub(Ay[a], Ty[v]));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = i == 0 ? 1 : 0, kk = i == 2 ? 1 : 2;
    const float d0 = D[i][0], d1 = D[i][1], d2 = D[i][2];
    // self strictly closest (ties go to the others), or the farthest vertex
    const bool far2 = (d2 >= d0) && (d2 >= d1);
    const bool far1 = !far2 && (d1 >= d0);
    const bool far0 = !far2 && !far1;
    const bool ok0 = ((d0 < D[j][0]) && (d0 < D[kk][0])) || far0;
    const bool ok1 = ((d1 < D[j][1]) && (d1 < D[kk][1])) || far1;
    const bool ok2 = ((d2 < D[j][2]) && (d2 < D[kk][2])) || far2;
    const float m0 = ok0 ? d0 : 3.4e38f, m1 = ok1 ? d1 : 3.4e38f, m2 = ok2 ? d2 : 3.4e38f;
    const bool p0 = (m0 <= m1) && (m0 <= m2);
    const bool p1 = !p0 && (m1 <= m2);
    const float vx = p0 ? Tx[0] : (p1 ? Tx[1] : Tx[2]);
    const float vy = p0 ? Ty[0] : (p1 ? Ty[1] : Ty[2]);
    float err = 0.f;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const int a = kSettledPerm[i][v];
      const float e = rn_sq2(rn_sub(Tx[v], Ax[a]), rn_sub(Ty[v], Ay[a]));
      err = v == 0 ? e : rn_add(err, e);
    }
    const float scale = err < 1e-4f ? 1.0f : 0.3f;
    const float cx = fminf(fmaxf(rn_mul(0.5f, rn_sub(vx, Ax[i])), -1.f), 1.f);
    const float cy = fminf(fmaxf(rn_mul(0.5f, rn_sub(vy, Ay[i])), -1.f), 1.f);
    out_x[i] = rn_mul(rn_add(cx, rn_mul(pvx, scale)), lvl);
    out_y[i] = rn_mul(rn_add(cy, rn_mul(pvy, scale)), lvl);
  }
}

// The arity-3 BFS + ezpolicy expansion over N = 3^L agents, by the whole
// block.  x, y, sx, sy: the leaves (N each).  pyr: 4 planes of (N - 1) / 2
// rows for pyramid levels 0 .. L-1.  pv: 4 x N floats, two (x, y) buffers.
// Returns the buffer holding the agents' actions (x at [0, N), y at
// [N, 2N)).  Every thread must call this (it synchronises).
static __device__ const float* bfs_ez_block(const float* x, const float* y,
                                            const float* sx, const float* sy,
                                            float* pyr, float* pv, int N, int L,
                                            float rvx, float rvy) {
  const int R = (N - 1) / 2;
  float* PX = pyr;
  float* PY = pyr + R;
  float* SX = pyr + 2 * R;
  float* SY = pyr + 3 * R;
  // level k of a pyramid: the leaves at k = L, else the planes above
  auto lvl = [&](const float* leaf, float* plane, int k) -> const float* {
    return k == L ? leaf : plane + pyr_off(k);
  };
  for (int k = L - 1, G = N / 3; k >= 0; --k, G /= 3) {
    const float* cx = lvl(x, PX, k + 1);
    const float* cy = lvl(y, PY, k + 1);
    const float* tx = lvl(sx, SX, k + 1);
    const float* ty = lvl(sy, SY, k + 1);
    const int o = pyr_off(k);
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      PX[o + g] = rn_div(rn_add(rn_add(cx[3 * g], cx[3 * g + 1]), cx[3 * g + 2]), 3.0f);
      PY[o + g] = rn_div(rn_add(rn_add(cy[3 * g], cy[3 * g + 1]), cy[3 * g + 2]), 3.0f);
      SX[o + g] = rn_div(rn_add(rn_add(tx[3 * g], tx[3 * g + 1]), tx[3 * g + 2]), 3.0f);
      SY[o + g] = rn_div(rn_add(rn_add(ty[3 * g], ty[3 * g + 1]), ty[3 * g + 2]), 3.0f);
    }
    __syncthreads();
  }

  float* in = pv;
  float* out = pv + 2 * N;
  if (threadIdx.x == 0) {
    in[0] = rvx;
    in[N] = rvy;
  }
  __syncthreads();
  for (int l = 0, G = 1; l < L; ++l, G *= 3) {
    const float* mx = lvl(x, PX, l + 1);  // members
    const float* my = lvl(y, PY, l + 1);
    const float* mtx = lvl(sx, SX, l + 1);
    const float* mty = lvl(sy, SY, l + 1);
    const float* gx = PX + pyr_off(l);  // group means
    const float* gy = PY + pyr_off(l);
    const float* gtx = SX + pyr_off(l);
    const float* gty = SY + pyr_off(l);
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float Ax[3], Ay[3], Tx[3], Ty[3], ox[3], oy[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Ax[i] = rn_sub(mx[3 * g + i], gx[g]);
        Ay[i] = rn_sub(my[3 * g + i], gy[g]);
        Tx[i] = rn_sub(mtx[3 * g + i], gtx[g]);
        Ty[i] = rn_sub(mty[3 * g + i], gty[g]);
      }
      ez_group(Ax, Ay, Tx, Ty, in[g], in[N + g], (float)(L - l), ox, oy);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        out[3 * g + i] = ox[i];
        out[N + 3 * g + i] = oy[i];
      }
    }
    __syncthreads();
    float* t = in;
    in = out;
    out = t;
  }
  return in;
}

// sqrt(max(max_i min_j |c_i - s_j|^2, max_j min_i |c_i - s_j|^2)) of the N
// agents (rx, ry) centred on their centroid into (cx, cy) and the shape
// (sx, sy), one squared distance per (agent, vertex).  The shape is padded
// to tiles of 32 with far vertices (FAR_VERTEX) and the rows past N are far
// agents on the other side, so that no step needs a mask: a pad's squared
// distance, about 1e36, never wins a minimum of a real row or column.
// colmin: N words of shared scratch.  Every thread must call this (it
// synchronises).
#define FAR_VERTEX 1e18f
static __device__ float haus_rect(const float* rx, const float* ry, const float* sx,
                                  const float* sy, float* cx, float* cy,
                                  unsigned* colmin, int N, float* scratch) {
  for (int t = threadIdx.x; t < N; t += blockDim.x) colmin[t] = __float_as_uint(FLT_MAX);
  block_centroid(rx, ry, cx, cy, N, scratch);  // ends with __syncthreads
  const int lane = threadIdx.x & 31;
  float worst = 0.f;  // squared distances are >= 0
  // every thread takes the same number of row passes, so that whole warps
  // take part in the shuffles
  for (int row0 = 0; row0 < N; row0 += blockDim.x) {
    const int i = row0 + threadIdx.x;
    const bool real = i < N;
    const float ax = real ? cx[i] : -FAR_VERTEX, ay = real ? cy[i] : -FAR_VERTEX;
    float rmin = FLT_MAX;
    for (int j0 = 0; j0 < N; j0 += 32) {
      float acc = FLT_MAX;  // at step s: the minimum of vertex j0 + (lane + s) % 32
#pragma unroll 8
      for (int s = 0; s < 32; ++s) {
        const int j = j0 + ((lane + s) & 31);
        const float dx = ax - sx[j], dy = ay - sy[j];
        const float d2 = dx * dx + dy * dy;
        rmin = fminf(rmin, d2);
        acc = __shfl_sync(0xffffffffu, fminf(acc, d2), (lane + 1) & 31);
      }
      if (j0 + lane < N) atomicMin(&colmin[j0 + lane], __float_as_uint(acc));
    }
    if (real) worst = fmaxf(worst, rmin);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < N; t += blockDim.x)
    worst = fmaxf(worst, __uint_as_float(colmin[t]));
  return sqrtf(block_reduce(worst, scratch, true));
}

__host__ __device__ inline size_t fused_step_smem_floats(int N, int L) {
  const size_t Ep = (size_t)((N + 31) / 32) * 32;
  size_t floats = 13 * Ep + (size_t)2 * N + 32;
  if (L > 0) floats += (size_t)4 * ((N - 1) / 2) + (size_t)4 * N;
  return floats;
}

__global__ void fused_step_kernel(
    const float* __restrict__ apos, const float* __restrict__ avel,
    const float* __restrict__ aforce, const float* __restrict__ ishape,
    const float* __restrict__ ivel, float* __restrict__ npos,
    float* __restrict__ nvel, float* __restrict__ haus,
    float* __restrict__ ncoll, int N, int pos_bstride, int vel_bstride, int L,
    int post, float k, float invk, float cf, float dmin, float thresh2,
    float keep, float fscale, float dt, float max_speed, float act_scale) {
  extern __shared__ float sh[];
  const int Ep = ((N + 31) >> 5) << 5;
  float* x = sh;              // input positions (Ep: pads at 0)
  float* y = x + Ep;
  float* qx = y + Ep;         // new positions (Ep: pads at 0)
  float* qy = qx + Ep;
  float* own = qy + Ep;       // the pair sweep's sums: 3 x Ep
  float* react = own + 3 * Ep;  // 3 x Ep
  unsigned* colmin = (unsigned*)(react + 3 * Ep);  // Ep
  float* sx = (float*)colmin + Ep;  // ideal shape (Ep: pads at FAR_VERTEX)
  float* sy = sx + Ep;
  float* cx = sy + Ep;        // statistics scratch: centred positions
  float* cy = cx + N;
  float* scratch = cy + N;    // 32 floats
  float* pyr = scratch + 32;           // L > 0: 4 x (N - 1) / 2
  float* pv = pyr + 4 * ((N - 1) / 2);  // L > 0: 4 x N

  const int b = blockIdx.x;
  const float* p_in = apos + (size_t)b * pos_bstride;
  const float* v_in = avel + (size_t)b * vel_bstride;
  const size_t base = (size_t)b * N * 2;
  for (int t = threadIdx.x; t < Ep; t += blockDim.x) {
    const bool real = t < N;
    x[t] = real ? p_in[2 * t] : 0.f;
    y[t] = real ? p_in[2 * t + 1] : 0.f;
    qx[t] = qy[t] = 0.f;
    sx[t] = real ? ishape[base + 2 * t] : FAR_VERTEX;
    sy[t] = real ? ishape[base + 2 * t + 1] : FAR_VERTEX;
    for (int c = 0; c < 3; ++c) own[c * Ep + t] = react[c * Ep + t] = 0.f;
  }
  __syncthreads();

  const float* act = nullptr;
  if (L > 0) act = bfs_ez_block(x, y, sx, sy, pyr, pv, N, L, ivel[2 * b], ivel[2 * b + 1]);

  const float c_exp = invk * 1.44269504f, c_log = k * 0.693147181f;
  if (post)
    pair_sweep(UniformPair<true, false>{x, y, c_exp, c_log, cf, dmin, thresh2}, N, own, react);
  else
    pair_sweep(UniformPair<true, true>{x, y, c_exp, c_log, cf, dmin, thresh2}, N, own, react);

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    float fx = own[i] + react[i];
    float fy = own[Ep + i] + react[Ep + i];
    if (L > 0) {
      fx += act_scale * act[i];
      fy += act_scale * act[N + i];
    } else {
      fx += aforce[base + 2 * i];
      fy += aforce[base + 2 * i + 1];
    }
    float vx = v_in[2 * i] * keep + fx * fscale;
    float vy = v_in[2 * i + 1] * keep + fy * fscale;
    if (max_speed < INFINITY) {  // eps-guarded clamp, as the TPU kernel
      const float sp2 = fmaxf(vx * vx + vy * vy, 1e-24f);
      const float rs = rsqrtf(sp2);
      const float scale = sp2 * rs > max_speed ? max_speed * rs : 1.f;
      vx *= scale;
      vy *= scale;
    }
    const float nx = x[i] + vx * dt, ny = y[i] + vy * dt;
    nvel[base + 2 * i] = vx;
    nvel[base + 2 * i + 1] = vy;
    npos[base + 2 * i] = nx;
    npos[base + 2 * i + 1] = ny;
    qx[i] = nx;
    qy[i] = ny;
    if (!post) ncoll[(size_t)b * N + i] = own[2 * Ep + i] + react[2 * Ep + i];
  }
  __syncthreads();  // post: qx/qy complete, own/react read

  if (post) {
    for (int t = threadIdx.x; t < Ep; t += blockDim.x) own[t] = react[t] = 0.f;
    __syncthreads();
    pair_sweep(UniformPair<false, true>{qx, qy, c_exp, c_log, cf, dmin, thresh2}, N, own, react);
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      ncoll[(size_t)b * N + i] = own[i] + react[i];
  }

  const float h = haus_rect(post ? qx : x, post ? qy : y, sx, sy, cx, cy, colmin, N, scratch);
  if (threadIdx.x == 0) haus[b] = h;
}

extern "C" int fused_step_launch(
    const void* apos, const void* avel, const void* aforce, const void* ishape,
    const void* ivel, void* npos, void* nvel, void* haus, void* ncoll, int B,
    int N, int pos_bstride, int vel_bstride, int L, int post, float k,
    float invk, float cf, float dmin, float thresh2, float keep, float fscale,
    float dt, float max_speed, float act_scale, void* stream) {
  if (B == 0 || N == 0) return 0;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = fused_step_smem_floats(N, L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_step_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)apos, (const float*)avel, (const float*)aforce,
      (const float*)ishape, (const float*)ivel, (float*)npos, (float*)nvel,
      (float*)haus, (float*)ncoll, N, pos_bstride, vel_bstride, L, post, k,
      invk, cf, dmin, thresh2, keep, fscale, dt, max_speed, act_scale);
  return (int)cudaGetLastError();
}
