// K5: the whole MAPPO collection on formation_hd, T steps per env, in one
// kernel.
//
// Replaces gym_formation_tpu/ops/pallas/fused_collect.py:fused_collect_hd
// (the _collect_kernel Pallas kernel).  Same function as the plain version
// gym_formation_tpu_torch/ops/kernels/fused_collect.py:fused_collect_hd_plain.
// Each step of each env: the n agents' observations from the state, the
// shared 64-64 GaussianActor on each and the centralized ValueCritic on their
// concatenation, a Box-Muller sample from the murmur3 counter PRNG keyed by
// (seed, step of the call, row + 131 * salt, env index) -- the JAX kernel's
// bits --, point-mass physics among the agents, the env reward
// n * shared - collisions, and the time-limit auto-reset.  The trajectory
// (obs, action, logp, value, reward, done) goes to device memory in the
// batch-second layout the update reads.
//
// What bounds it on the H100: FP32 issue in the layer products.  At n=3 an
// env-step is 23,744 multiply-adds (actor 3 x 5,376, critic 7,616) against a
// few hundred operations of physics and reward, and the trajectory write is
// 70 floats per env and step.  The exactness contract below rounds every
// multiply and every add on its own (no FMA), so a multiply-add is two FP32
// instructions: at n=3, B=4096, T=25 the 2.431 G multiply-adds take at least
// 2.431e9 x 2 / (132 SMs x 128 lanes x 1.98 GHz) = 0.145 ms.
//
// Design: a tile of E consecutive envs a block of NT = 256 threads, in a
// persistent grid (the wrapper sizes it from the occupancy the compiled
// kernel gets, fused_collect_plan); each block stages every weight in shared
// memory once, reading the [out][in] rows coalesced and writing them
// transposed to [in][WS] (WS = 68: a 16-byte-aligned row, and the transposed
// writes fall on 8 banks, not 1), then walks the tiles b0 = (blockIdx.x +
// k gridDim.x) E.  E by n, the largest power of two up to 16 whose weights
// and activations fit a block's 227 KB (the wrapper's launch_plan):
//
//   n = 3  E = 16  95,632 bytes   two blocks an SM; 256 tiles at B = 4096
//                                 fill 256 of the 264 slots of 132 SMs
//   n = 4  E = 16  120,464 bytes  one block an SM
//   n = 9  E = 4   213,904 bytes  one block an SM (the weights alone are
//                                 183.5 KB: the critic's first layer is
//                                 486 x 64 floats)
//
// At n = 3, E = 32 would give 128 blocks, fewer than the SMs, and E = 8
// three blocks an SM over 512 tiles: 1.3 waves.  With two blocks an SM, one
// block's scalar phase and barriers overlap the other's products.
//
// A step of a tile:
//   products  rows are env x agent for the actor (E n rows) and env for the
//             critic (E rows), units the 64 hidden units; thread (ug, rg) =
//             (tid % 16, tid / 16) owns units 4 ug .. 4 ug + 3 of rows
//             rg + 16 j (an RA x 4 tile for the actor, RA = ceil(E n / 16),
//             RC x 4 for the critic).  Activations sit [row][k] in shared
//             memory (the obs of an env is its contiguous trajectory slab; a
//             hidden row has HS = 68 floats, 16-byte aligned, and the two
//             rows a warp reads fall on different banks), weights [k][unit]:
//             a k step is one 16-byte weight load, 4 RA multiplies and adds,
//             and RA broadcast loads of the inputs (the first layer) or a
//             quarter of RA 16-byte loads (the second, 4 k at a time).
//   heads     the 2n action means and the value of each env are spread over
//             the block's threads, one 64-term sum each: E (2n + 1) of them.
//   scalar    thread e < E holds env b0 + e's state in registers across the
//             T steps and runs its log-density, contact forces, integration,
//             reward, collisions, done and reset, then builds its next
//             observations; meanwhile the block's last threads draw the next
//             step's normals (double-buffered by step parity).  Each
//             unordered pair's contact coefficient is computed once (it is
//             symmetric bit for bit), and the Hausdorff distance takes one
//             sqrt of the reduced squares (sqrt is monotone): n (n - 1) / 2
//             pairs' transcendentals and one sqrt where the plain version
//             takes n (n - 1) and n^2, with the same bits.
// Four barriers a step.  The trajectory slabs of the tile (E consecutive
// envs) are contiguous: obs is copied from shared memory by all threads,
// actions and values are written by the head threads, both coalesced.  The
// reset's numbers are drawn only on the step an env resets, a branch within
// the warp (the generator is counter-based, so the bits are those of the
// JAX kernel, which draws them every step).
//
// Exactness: every operation is rounded on its own (rn_*: no contraction into
// fused multiply-adds), in the plain version's order -- each layer output is
// a running sum over its inputs in order, then the bias, then the relu --,
// with the CUDA math library's logf / cosf / expf / log1pf and correctly
// rounded sqrt, as PyTorch's own CUDA kernels call them, so the card's kernel
// and the plain version agree bit for bit.  The collision counts decide the
// reward, so their predicate is rounded step by step as K2's is.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int H = 64;    // hidden width of both MLPs
constexpr int NT = 256;  // threads a block
constexpr int WS = 68;   // row stride of a transposed weight matrix [in][WS]
constexpr int HS = 68;   // row stride of a hidden activation [row][HS], 16-byte aligned
constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float TWO_PI = 6.2831854820251465f;  // 2 * float32(pi)

// Uniform (0, 1] keyed by (seed, it, row, salt, lane), the JAX _uniform01.
__device__ __forceinline__ float uniform01(unsigned seed, unsigned it, unsigned row,
                                           unsigned salt, unsigned lane) {
  const unsigned ctr =
      (seed * 2654435761u) ^ (it * 0x9E3779B9u) ^ ((row + salt * 131u) * 0x27D4EB2Fu);
  const unsigned bits = hash_u32(ctr + lane);
  return rn_sub(1.0f, rn_mul((float)(int)(bits >> 8), 1.0f / 16777216.0f));
}

// Standard normal by Box-Muller over the uniforms of salt and salt + 7.
__device__ __forceinline__ float normal(unsigned seed, unsigned it, unsigned row,
                                        unsigned salt, unsigned lane) {
  const float u1 = uniform01(seed, it, row, salt, lane);
  const float u2 = uniform01(seed, it, row, salt + 7u, lane);
  const float r = __fsqrt_rn(rn_mul(-2.0f, logf(u1)));
  return rn_mul(r, cosf(rn_mul(TWO_PI, u2)));
}

// Shared memory of a block at n agents and E envs a tile, in floats.  Must
// equal ops/kernels/fused_collect.py: smem_bytes / 4.
template <int n, int E>
struct Dims {
  static constexpr int DO = 6 * n;   // one agent's observation
  static constexpr int DC = n * DO;  // the critic's input
  static constexpr int A = 2 * n;    // actions of one env
  static constexpr int RA = (E * n + 15) / 16;  // actor rows a thread
  static constexpr int RC = (E + 15) / 16;      // critic rows a thread
  // aw1, aw2, cw1, cw2 transposed; ab1, ab2, cb1, cb2, aw3 [2][H], cw3;
  // ab3 [2], cb3 and one pad
  static constexpr int W = (DO + H + DC + H) * WS + 7 * H + 4;
  // obs [E][DC], h1 and h2 [E n][HS], k1 and k2 [E][HS], normals [2][E A],
  // actions [E A]
  static constexpr int S = E * (DC + 2 * n * HS + 2 * HS + 3 * A);
  static constexpr int SMEM = (W + S) * (int)sizeof(float);
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;  // the SM's 228 KB
};

struct Weights {
  const float *aw1, *ab1, *aw2, *ab2, *aw3, *ab3, *als;
  const float *cw1, *cb1, *cw2, *cb2, *cw3, *cb3;
};

struct Traj {
  float *obs, *act, *logp, *val, *rew;
  unsigned char* done;
};

// w [out][K] in device memory -> ws [K][WS] in shared memory: coalesced reads
// along the rows, U of them in flight a thread.
template <int K>
__device__ __forceinline__ void stage_transposed(const float* __restrict__ w, float* ws) {
  constexpr int N = H * K, U = 8;
  for (int i0 = threadIdx.x; i0 < N; i0 += U * NT) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = i0 + u * NT < N ? __ldg(w + i0 + u * NT) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT;
      if (i < N) ws[(i % K) * WS + i / K] = v[u];
    }
  }
}

// y[r][u] = relu(b[u] + sum_k w[k][u] x[r][k]) for the rows r < rows, the
// sum a running one over k in order, each multiply and add rounded on its
// own (from -0: -0 + p is p, so the first term is the first product, as in
// the plain version).  Thread (ug, rg) takes units 4 ug .. 4 ug + 3 of the
// rows rg + 16 j, j < RT; x has rows of stride xs, y of stride HS.  V4:
// the rows of x are 16-byte aligned and K a multiple of 4, and a thread
// loads 4 k of a row at once.
template <int RT, int K, bool V4>
__device__ __forceinline__ void dense_relu(const float* x, int xs, const float* w,
                                           const float* bias, float* y, int rows, int ug,
                                           int rg) {
  if (rg >= rows) return;  // no row of this thread in the tile (the critic at E < 16)
  const float* xr[RT];
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int r = rg + 16 * j;
    xr[j] = x + (r < rows ? r : rows - 1) * xs;  // a row past the tile reads a real one
  }
  float acc[RT][4];
#pragma unroll
  for (int j = 0; j < RT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = -0.f;
  auto mac = [&](int k, const float (&v)[RT]) {
    const float4 wk = *reinterpret_cast<const float4*>(w + k * WS + 4 * ug);
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      acc[j][0] = rn_add(acc[j][0], rn_mul(wk.x, v[j]));
      acc[j][1] = rn_add(acc[j][1], rn_mul(wk.y, v[j]));
      acc[j][2] = rn_add(acc[j][2], rn_mul(wk.z, v[j]));
      acc[j][3] = rn_add(acc[j][3], rn_mul(wk.w, v[j]));
    }
  };
  if constexpr (V4) {
    static_assert(K % 4 == 0, "V4 takes K in groups of 4");
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float v[4][RT];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const float4 x4 = *reinterpret_cast<const float4*>(xr[j] + k);
        v[0][j] = x4.x;
        v[1][j] = x4.y;
        v[2][j] = x4.z;
        v[3][j] = x4.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) mac(k + q, v[q]);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float v[RT];
#pragma unroll
      for (int j = 0; j < RT; ++j) v[j] = xr[j][k];
      mac(k, v);
    }
  }
  const float4 bb = *reinterpret_cast<const float4*>(bias + 4 * ug);
#pragma unroll
  for (int j = 0; j < RT; ++j) {
    const int r = rg + 16 * j;
    if (r < rows)
      *reinterpret_cast<float4*>(y + r * HS + 4 * ug) =
          make_float4(fmaxf(rn_add(acc[j][0], bb.x), 0.f), fmaxf(rn_add(acc[j][1], bb.y), 0.f),
                      fmaxf(rn_add(acc[j][2], bb.z), 0.f), fmaxf(rn_add(acc[j][3], bb.w), 0.f));
  }
}

// sum_k w[k] x[k] over the H hidden units, in order (from -0, as
// dense_relu); w and x 16-byte aligned
__device__ __forceinline__ float dot_h(const float* w, const float* x) {
  float s = -0.f;
#pragma unroll 4
  for (int k = 0; k < H; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(w + k);
    const float4 b = *reinterpret_cast<const float4*>(x + k);
    s = rn_add(s, rn_mul(a.x, b.x));
    s = rn_add(s, rn_mul(a.y, b.y));
    s = rn_add(s, rn_mul(a.z, b.z));
    s = rn_add(s, rn_mul(a.w, b.w));
  }
  return s;
}

// One env's state, held by its thread across the steps of a tile.
template <int n>
struct Env {
  float px[n], py[n], vx[n], vy[n], sx[n], sy[n], ivx, ivy;
  int t;
};

// Env's n observations [n][6n] into ob: per agent i, its velocity, p_j - p_i
// for j != i, 2(n - 1) zeros (silent agents), the flat ideal shape and the
// ideal velocity.
template <int n>
__device__ __forceinline__ void build_obs(const Env<n>& s, float* ob) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float* o = ob + i * 6 * n;
    o[0] = s.vx[i];
    o[1] = s.vy[i];
    int k = 2;
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (j == i) continue;
      o[k++] = rn_sub(s.px[j], s.px[i]);
      o[k++] = rn_sub(s.py[j], s.py[i]);
    }
#pragma unroll
    for (int c = 0; c < 2 * (n - 1); ++c) o[k++] = 0.f;
#pragma unroll
    for (int v = 0; v < n; ++v) {
      o[k++] = s.sx[v];
      o[k++] = s.sy[v];
    }
    o[k++] = s.ivx;
    o[k] = s.ivy;
  }
}

// The step of env b (row: its trajectory row) after the actions: the
// log-density of the normals z [2n], the physics of the actions act [2n],
// the reward of the stepped state, done and the auto-reset.
template <int n>
__device__ __forceinline__ void env_step(Env<n>& s, const float* z, const float* act, Traj tr,
                                         size_t row, unsigned b, unsigned it, unsigned seed,
                                         int ep_len, float ls_sum, float sens, float dmin,
                                         float thresh2, float cf, float margin, float invk,
                                         float keep, float dt) {
  const float fn = (float)n;
  float fx[n], fy[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float z0 = z[2 * i], z1 = z[2 * i + 1];
    const float q = rn_mul(-0.5f, rn_add(rn_mul(z0, z0), rn_mul(z1, z1)));
    tr.logp[row * n + i] = rn_sub(rn_sub(q, ls_sum), LOG_2PI);
    fx[i] = rn_mul(sens, act[2 * i]);
    fy[i] = rn_mul(sens, act[2 * i + 1]);
  }
  // physics among the agents (mass 1).  The coefficient of a pair is
  // symmetric bit for bit (rn_sub(a, b) = -rn_sub(b, a), so both directions
  // square the same values): each unordered pair's is computed once, then
  // agent i sums its terms over j = 0 .. n - 1 in order, as the plain version.
  float kc[n][n];
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = i + 1; j < n; ++j) {
      const float dist = __fsqrt_rn(rn_sq2(rn_sub(s.px[i], s.px[j]), rn_sub(s.py[i], s.py[j])));
      const float zz = rn_mul(rn_sub(dmin, dist), invk);
      const float pen = rn_mul(rn_add(fmaxf(zz, 0.f), log1pf(expf(-fabsf(zz)))), margin);
      kc[i][j] = rn_div(rn_mul(cf, pen), fmaxf(dist, 1e-12f));
    }
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (i == j) continue;
      const float k = i < j ? kc[i][j] : kc[j][i];
      fx[i] = rn_add(fx[i], rn_mul(k, rn_sub(s.px[i], s.px[j])));
      fy[i] = rn_add(fy[i], rn_mul(k, rn_sub(s.py[i], s.py[j])));
    }
  float nvx[n], nvy[n], npx[n], npy[n];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    nvx[i] = rn_add(rn_mul(s.vx[i], keep), rn_mul(fx[i], dt));
    nvy[i] = rn_add(rn_mul(s.vy[i], keep), rn_mul(fy[i], dt));
    npx[i] = rn_add(s.px[i], rn_mul(nvx[i], dt));
    npy[i] = rn_add(s.py[i], rn_mul(nvy[i], dt));
  }
  // reward of the stepped state: n * shared - collisions
  const float nmx = mean_n<n>(npx), nmy = mean_n<n>(npy);
  float ncx[n], ncy[n];
#pragma unroll
  for (int a = 0; a < n; ++a) {
    ncx[a] = rn_sub(npx[a], nmx);
    ncy[a] = rn_sub(npy[a], nmy);
  }
  // the minima and maxima on squared distances and one sqrt: a correctly
  // rounded sqrt is monotone, so this is the plain version's max of minima
  // of square roots, bit for bit
  float rmax = 0.f, cmax = 0.f, colmin[n];
#pragma unroll
  for (int a = 0; a < n; ++a) {
    float rmin = 0.f;
#pragma unroll
    for (int v = 0; v < n; ++v) {
      const float d2 = rn_sq2(rn_sub(ncx[a], s.sx[v]), rn_sub(ncy[a], s.sy[v]));
      rmin = v == 0 ? d2 : fminf(rmin, d2);
      colmin[v] = a == 0 ? d2 : fminf(colmin[v], d2);
    }
    rmax = a == 0 ? rmin : fmaxf(rmax, rmin);
  }
#pragma unroll
  for (int v = 0; v < n; ++v) cmax = v == 0 ? colmin[v] : fmaxf(cmax, colmin[v]);
  const float haus = __fsqrt_rn(fmaxf(rmax, cmax));
  const float dvx = rn_sub(s.ivx, mean_n<n>(nvx)), dvy = rn_sub(s.ivy, mean_n<n>(nvy));
  const float shared = rn_sub(-haus, __fsqrt_rn(rn_sq2(dvx, dvy)));
  float ncoll = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = i + 1; j < n; ++j)
      if (rn_sq2(rn_sub(npx[i], npx[j]), rn_sub(npy[i], npy[j])) < thresh2) ncoll += 2.f;
  tr.rew[row] = rn_sub(rn_mul(shared, fn), ncoll);

  // time limit and auto-reset
  const int nt = s.t + 1;
  const bool done = nt >= ep_len;
  tr.done[row] = done ? 1 : 0;
  if (done) {
    auto draw = [&](int r) { return rn_sub(rn_mul(uniform01(seed, it, r, 3u, b), 2.0f), 1.0f); };
    float lx[n], ly[n];
#pragma unroll
    for (int a = 0; a < n; ++a) {
      s.px[a] = draw(a);
      s.py[a] = draw(n + a);
      lx[a] = draw(2 * n + a);
      ly[a] = draw(3 * n + a);
      s.vx[a] = 0.f;
      s.vy[a] = 0.f;
    }
    const float lmx = mean_n<n>(lx), lmy = mean_n<n>(ly);
#pragma unroll
    for (int a = 0; a < n; ++a) {
      s.sx[a] = rn_sub(lx[a], lmx);
      s.sy[a] = rn_sub(ly[a], lmy);
    }
    s.ivx = draw(4 * n);
    s.ivy = draw(4 * n + 1);
    s.t = 0;
  } else {
#pragma unroll
    for (int a = 0; a < n; ++a) {
      s.px[a] = npx[a];
      s.py[a] = npy[a];
      s.vx[a] = nvx[a];
      s.vy[a] = nvy[a];
    }
    s.t = nt;
  }
}

// The normals of step it of the tile's envs into z [E][2n]: z[e][o] =
// normal(seed, it, o, 1, b0 + e), drawn by the block's last threads (the
// first E run the envs).
template <int n, int E>
__device__ __forceinline__ void draw_normals(float* z, unsigned seed, unsigned it, int b0) {
  constexpr int A = 2 * n;
  for (int j = NT - 1 - (int)threadIdx.x; j < E * A; j += NT)
    z[j] = normal(seed, it, (unsigned)(j % A), 1u, (unsigned)(b0 + j / A));
}

template <int n, int E>
__global__ void __launch_bounds__(NT, Dims<n, E>::MIN_BLOCKS) fused_collect_kernel(
    const float* __restrict__ ap_in, const float* __restrict__ av_in,
    const float* __restrict__ is_in, const float* __restrict__ iv_in,
    const int* __restrict__ t_in, Weights g, float* __restrict__ ap_out,
    float* __restrict__ av_out, float* __restrict__ is_out, float* __restrict__ iv_out,
    int* __restrict__ t_out, Traj tr, int B, int T, int ep_len, unsigned seed, float sens,
    float dmin, float thresh2, float cf, float margin, float invk, float keep, float dt) {
  using D = Dims<n, E>;
  constexpr int DO = D::DO, DC = D::DC, A = D::A;
  extern __shared__ __align__(16) float smem[];
  float* aw1 = smem;          // [DO][WS]
  float* aw2 = aw1 + DO * WS;  // [H][WS]
  float* cw1 = aw2 + H * WS;   // [DC][WS]
  float* cw2 = cw1 + DC * WS;  // [H][WS]
  float* ab1 = cw2 + H * WS;
  float* ab2 = ab1 + H;
  float* cb1 = ab2 + H;
  float* cb2 = cb1 + H;
  float* aw3 = cb2 + H;        // [2][H]
  float* cw3 = aw3 + 2 * H;    // [H]
  float* hb = cw3 + H;         // ab3[0], ab3[1], cb3
  float* obs = hb + 4;         // [E][DC]: the tile's trajectory slab
  float* h1 = obs + E * DC;    // [E n][HS]
  float* h2 = h1 + E * n * HS;
  float* k1 = h2 + E * n * HS;  // [E][HS]
  float* k2 = k1 + E * HS;
  float* zb = k2 + E * HS;     // [2][E A], by step parity
  float* act = zb + 2 * E * A;  // [E A]

  const int tid = threadIdx.x, ug = tid & 15, rg = tid >> 4;
  stage_transposed<DO>(g.aw1, aw1);
  stage_transposed<H>(g.aw2, aw2);
  stage_transposed<DC>(g.cw1, cw1);
  stage_transposed<H>(g.cw2, cw2);
  for (int i = tid; i < H; i += NT) {
    ab1[i] = g.ab1[i];
    ab2[i] = g.ab2[i];
    cb1[i] = g.cb1[i];
    cb2[i] = g.cb2[i];
    aw3[i] = g.aw3[i];
    aw3[H + i] = g.aw3[H + i];
    cw3[i] = g.cw3[i];
  }
  if (tid < 2) hb[tid] = g.ab3[tid];
  if (tid == 0) hb[2] = g.cb3[0];

  const float ls0 = g.als[0], ls1 = g.als[1];
  const float std0 = expf(ls0), std1 = expf(ls1);
  const float ls_sum = rn_add(ls0, ls1);

  for (int b0 = blockIdx.x * E; b0 < B; b0 += gridDim.x * E) {
    const int nv = min(E, B - b0);  // envs of the tile
    const int b = b0 + tid;         // thread tid < E: this env
    const bool mine = tid < nv;
    Env<n> s = {};
    if (mine) {
#pragma unroll
      for (int a = 0; a < n; ++a) {
        s.px[a] = ap_in[(size_t)a * B + b];
        s.py[a] = ap_in[(size_t)(n + a) * B + b];
        s.vx[a] = av_in[(size_t)a * B + b];
        s.vy[a] = av_in[(size_t)(n + a) * B + b];
        s.sx[a] = is_in[(size_t)a * B + b];
        s.sy[a] = is_in[(size_t)(n + a) * B + b];
      }
      s.ivx = iv_in[b];
      s.ivy = iv_in[B + b];
      s.t = t_in[b];
    }
    if (tid < E) build_obs<n>(s, obs + tid * DC);  // past the batch: zeros
    draw_normals<n, E>(zb, seed, 0u, b0);
    __syncthreads();  // weights, observations and normals in place

    for (int it = 0; it < T; ++it) {
      const size_t row0 = (size_t)it * B + b0;  // trajectory row of the tile's first env
      const float* z = zb + (it & 1) * E * A;
      for (int i = tid; i < nv * DC; i += NT) tr.obs[row0 * DC + i] = obs[i];
      // ---- layer 1
      dense_relu<D::RA, DO, false>(obs, DO, aw1, ab1, h1, E * n, ug, rg);
      dense_relu<D::RC, DC, false>(obs, DC, cw1, cb1, k1, E, ug, rg);
      __syncthreads();
      // ---- layer 2
      dense_relu<D::RA, H, true>(h1, HS, aw2, ab2, h2, E * n, ug, rg);
      dense_relu<D::RC, H, true>(k1, HS, cw2, cb2, k2, E, ug, rg);
      __syncthreads();
      // ---- heads: action means and samples (t < E A), values
      for (int t = tid; t < E * (A + 1); t += NT) {
        if (t < E * A) {
          const int d = t & 1;
          const float m = rn_add(dot_h(aw3 + d * H, h2 + (t >> 1) * HS), hb[d]);
          const float a = rn_add(m, rn_mul(d ? std1 : std0, z[t]));
          act[t] = a;
          if (t < nv * A) tr.act[row0 * A + t] = a;
        } else {
          const int e = t - E * A;
          const float v = rn_add(dot_h(cw3, k2 + e * HS), hb[2]);
          if (e < nv) tr.val[row0 + e] = v;
        }
      }
      __syncthreads();
      // ---- scalar phase: one thread an env
      if (mine)
        env_step<n>(s, z + tid * A, act + tid * A, tr, row0 + tid, (unsigned)b, (unsigned)it, seed,
                    ep_len, ls_sum, sens, dmin, thresh2, cf, margin, invk, keep, dt);
      if (tid < E && it + 1 < T) build_obs<n>(s, obs + tid * DC);
      // ---- end of the scalar phase
      if (it + 1 < T) draw_normals<n, E>(zb + ((it + 1) & 1) * E * A, seed, (unsigned)(it + 1), b0);
      __syncthreads();
    }

    if (mine) {
#pragma unroll
      for (int a = 0; a < n; ++a) {
        ap_out[(size_t)a * B + b] = s.px[a];
        ap_out[(size_t)(n + a) * B + b] = s.py[a];
        av_out[(size_t)a * B + b] = s.vx[a];
        av_out[(size_t)(n + a) * B + b] = s.vy[a];
        is_out[(size_t)a * B + b] = s.sx[a];
        is_out[(size_t)(n + a) * B + b] = s.sy[a];
      }
      iv_out[b] = s.ivx;
      iv_out[B + b] = s.ivy;
      t_out[b] = s.t;
    }
  }
}

template <int n, int E>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(fused_collect_kernel<n, E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Dims<n, E>::SMEM);
}

// Resident blocks an SM of the (n, E) kernel at its shared memory
template <int n, int E>
int plan(int smem) {
  if (smem != Dims<n, E>::SMEM) return -2;
  int blocks = 0;
  if (set_smem<n, E>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_collect_kernel<n, E>, NT,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <int n, int E>
int launch(const void* const* in, const Weights& w, void* const* out, const Traj& tr, int B,
           int T, int ep_len, unsigned seed, const float* c, int G, int smem, cudaStream_t s) {
  if (smem != Dims<n, E>::SMEM || G < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_smem<n, E>();
  if (err != cudaSuccess) return (int)err;
  fused_collect_kernel<n, E><<<G, NT, smem, s>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const int*)in[4], w, (float*)out[0], (float*)out[1], (float*)out[2], (float*)out[3],
      (int*)out[4], tr, B, T, ep_len, seed, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan of the kernel for n agents and E envs a tile at smem bytes
// of shared memory (the wrapper's launch_plan): the resident blocks an SM;
// -2 where (n, E, smem) is not an instantiated kernel's, -1 on a CUDA error.
extern "C" int fused_collect_plan(int n, int E, int smem) {
  if (n == 3 && E == 16) return plan<3, 16>(smem);
  if (n == 4 && E == 16) return plan<4, 16>(smem);
  if (n == 9 && E == 4) return plan<9, 4>(smem);
  return -2;
}

// E envs a tile, G blocks, smem bytes a block: the wrapper's launch plan.
extern "C" int fused_collect_launch(
    const void* ap, const void* av, const void* ishape, const void* ivel, const void* t,
    const void* aw1, const void* ab1, const void* aw2, const void* ab2, const void* aw3,
    const void* ab3, const void* als, const void* cw1, const void* cb1, const void* cw2,
    const void* cb2, const void* cw3, const void* cb3, void* ap_out, void* av_out,
    void* is_out, void* iv_out, void* t_out, void* obs, void* act, void* logp, void* val,
    void* rew, void* done, int B, int n, int T, int ep_len, int E, int G, int smem,
    unsigned seed, float sens, float dmin, float thresh2, float cf, float margin, float invk,
    float keep, float dt, void* stream) {
  if (B == 0 || T == 0) return 0;
  const void* in[5] = {ap, av, ishape, ivel, t};
  void* out[5] = {ap_out, av_out, is_out, iv_out, t_out};
  const Weights w = {(const float*)aw1, (const float*)ab1, (const float*)aw2, (const float*)ab2,
                     (const float*)aw3, (const float*)ab3, (const float*)als, (const float*)cw1,
                     (const float*)cb1, (const float*)cw2, (const float*)cb2, (const float*)cw3,
                     (const float*)cb3};
  const Traj tr = {(float*)obs, (float*)act, (float*)logp, (float*)val, (float*)rew,
                   (unsigned char*)done};
  const float c[8] = {sens, dmin, thresh2, cf, margin, invk, keep, dt};
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 3 && E == 16) return launch<3, 16>(in, w, out, tr, B, T, ep_len, seed, c, G, smem, s);
  if (n == 4 && E == 16) return launch<4, 16>(in, w, out, tr, B, T, ep_len, seed, c, G, smem, s);
  if (n == 9 && E == 4) return launch<9, 4>(in, w, out, tr, B, T, ep_len, seed, c, G, smem, s);
  return (int)cudaErrorInvalidValue;
}
