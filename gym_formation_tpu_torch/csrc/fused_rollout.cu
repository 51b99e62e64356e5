// K4: a whole formation_hd + ezpolicy rollout, T steps per env, in one
// kernel.
//
// Replaces gym_formation_tpu/ops/pallas/fused_rollout.py:fused_rollout_hd
// (the _rollout_kernel Pallas kernel, PRNG _hash_u32 / _uniform_pm1).  Same
// function as the plain version
// gym_formation_tpu_torch/ops/kernels/fused_rollout.py:fused_rollout_hd_plain.
// Each step of each env: ezpolicy from the state, point-mass physics with
// soft contacts among the n agents, the shared reward
// n * (n * (-haus - |ivel - mean v|) - collisions) added to the env's sum,
// and the time-limit auto-reset, drawn from a murmur3 counter PRNG keyed by
// (seed, step of the call, row, env index) -- the JAX package's bits.
//
// What bounds it on the H100: latency.  A step is a few hundred dependent
// FP32 operations an env (at n=3: the n^2 agent-vertex roots of the policy,
// n(n-1)/2 contact coefficients, each a root, an expf, a log1pf and an IEEE
// division, the reward's distances) and device memory is touched only at
// the start and end of the call (about 26 n bytes per env).  At B=4096 and
// one thread an env there would be 128 warps, one on each of 128 SMs: one
// scheduler in four busy, and each step the length of one thread's chain.
//
// Design: each env on a group of n lanes of one warp, lane a for agent a
// (and for ideal vertex a); a warp holds G = 32 / n envs (10 at n=3, 8 at
// n=4, 3 at n=9; the other lanes idle), so B=4096 at n=3 is 410 warps
// spread over all SMs and their four schedulers.  Blocks of WARPS warps
// walk the env groups w, w + W, ... (W the warps of the grid, which the
// wrapper sizes from the occupancy API: fused_rollout_plan).  Agent a's
// position, velocity and vertex stay in lane a's registers across the T
// steps; every lane also holds the whole ideal shape and all n positions
// (the latter gathered by __shfl_sync after each step), and the env-wide
// scalars (ideal velocity, step counter, reward sum) are the same on every
// lane of the group.  A step:
//   pairs     lane a computes the coefficients of pairs (a, a + d mod n),
//             d = 1 .. n/2, first (they do not depend on the policy, so the
//             two chains interleave): every unordered pair once (at even n
//             the pairs d = n/2 twice, the same bits).  They go into the
//             env's [n][n] matrix in shared memory after the policy, and
//             lane a sums its n - 1 terms over j = 0 .. n-1 in order from
//             the policy force, as the plain version.  The coefficient is
//             symmetric bit for bit (rn_sub(x, y) = -rn_sub(y, x), so both
//             directions square the same values).
//   policy    lane a computes its agent's row of agent-vertex distances and
//             its vertex's column; the column's argmin (the vertex's nearest
//             agent) is gathered from the group, then far, pick, target and
//             the settled test stay in the lane.  Every comparison that picks
//             an index compares roots, as the plain version does (two squares
//             can round to one root, and the tie goes to the first index).
//   reward    the Hausdorff minima and maxima on squared distances (lane a:
//             its agent's row and its vertex's column), a max over the group
//             and one root (sqrt is monotone, so this is the plain version's
//             max of minima of roots, bit for bit); collisions counted over
//             the unordered pairs as above and summed over the group.
//   reset     on a step where an env of the warp resets, every lane draws
//             its agent's position and vertex (uniform control flow), and
//             the ideal shape is centred on the gathered draws in agent
//             order (the generator is counter-based, so the bits are those
//             of the JAX kernel, which draws every step).
// The step has no branch.  A correctly rounded sqrt or division carries a
// slow-path branch, which cuts the loop body into blocks the compiler does
// not interleave: the step became the sum of its instructions' latencies.
// So the step runs on branch-free fast paths (common.cuh: sqrt_rn_fast;
// div_rn_core for the means; div_rn_fast for the contact coefficient, whose
// numerator runs down to subnormals and zero as a pair parts).  Where an
// operand of an active lane falls outside their range, the warp leaves its
// loop of fast steps and takes that step on __fsqrt_rn / __fdiv_rn
// (env_step<n, false>): the same bits either way.
//
// Exactness: every operation is spelled with rn_* (no contraction into fused
// multiply-adds), in the plain version's order, and the transcendentals are
// the CUDA math library's expf / log1pf and the correctly rounded sqrt and
// division, which PyTorch's CUDA kernels call too: on the card the kernel
// and the plain version agree bit for bit, so a policy comparison never
// flips between them.  Means are summed in agent order on the gathered
// values, so every lane of a group gets the same bits.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 2;  // warps a block: the wrapper's launch_plan
constexpr unsigned FULL = 0xffffffffu;

template <int n>
struct Lanes {
  static constexpr int G = 32 / n;                // envs a warp
  static constexpr int SLOTS = (32 + n - 1) / n;  // groups a warp, the idle lanes' one included
  static constexpr int D = n / 2;                 // pair offsets a lane takes
};

struct Consts {
  float sens, dmin, thresh2, cf, margin, invk, keep, dt;
};

// A lane's state: its agent's position and velocity, its vertex, every
// agent's position, the whole ideal shape and the env's ideal velocity
template <int n>
struct LaneState {
  float px, py, vx, vy, sxo, syo, ivx, ivy;
  float qx[n], qy[n], sx[n], sy[n];
};

// A step's result: the lane's agent stepped, every agent's new position,
// and the env's reward n * (n * shared - collisions)
template <int n>
struct StepOut {
  float px, py, vx, vy, rew;
  float qx[n], qy[n];
};

// Uniform [-1, 1) keyed by (seed, it, row, lane), as the JAX _uniform_pm1.
__device__ __forceinline__ float uniform_pm1(unsigned seed, unsigned it, unsigned row,
                                             unsigned lane) {
  const unsigned ctr = (seed * 2654435761u) ^ (it * 0x9E3779B9u) ^ (row * 0x27D4EB2Fu);
  const unsigned bits = hash_u32(ctr + lane);
  const float u01 = rn_mul((float)(int)(bits >> 8), 1.0f / 16777216.0f);
  return rn_sub(rn_mul(u01, 2.0f), 1.0f);
}

// v of each lane of the group (first lane base) into out, in agent order
template <int n, typename V>
__device__ __forceinline__ void gather(V v, int base, V (&out)[n]) {
#pragma unroll
  for (int k = 0; k < n; ++k) out[k] = __shfl_sync(FULL, v, base + k);
}

// The correctly rounded sqrt and division: the branch-free fast path (ok
// turns false where an operand is outside its range), or the intrinsic
template <bool FAST>
__device__ __forceinline__ float sqrt_k(float x, bool& ok) {
  if constexpr (FAST) {
    ok &= sqrt_rn_fast_ok(x);
    return sqrt_rn_fast(x);
  }
  return __fsqrt_rn(x);
}

template <bool FAST>
__device__ __forceinline__ float div_k(float x, float y, bool& ok) {
  if constexpr (FAST) {
    ok &= div_rn_fast_ok(x, y);
    return div_rn_fast(x, y);
  }
  return __fdiv_rn(x, y);
}

// mean_n on div_rn_core (a sum below 2^-76 is out of its range: the step
// falls back)
template <int n, bool FAST>
__device__ __forceinline__ float mean_k(const float (&v)[n], bool& ok) {
  float s = v[0];
#pragma unroll
  for (int a = 1; a < n; ++a) s = rn_add(s, v[a]);
  if constexpr (FAST) {
    ok &= div_rn_core_ok(s, (float)n);
    return div_rn_core(s, (float)n);
  }
  return __fdiv_rn(s, (float)n);
}

// One env step of lane a (agent a, vertex a) of the group at lane base,
// into o; km is the env's [n][n] coefficient matrix in shared memory.
// Returns false where an operand of the fast paths was out of their range
// (FAST only); every lane of the warp must call it.
template <int n, bool FAST>
__device__ __forceinline__ bool env_step(const LaneState<n>& s, StepOut<n>& o, float* km, int a,
                                         int base, const int (&part)[Lanes<n>::D], const Consts& c) {
  constexpr int D = Lanes<n>::D;
  const float fn = (float)n;
  bool ok = true;
  // ---- pair coefficients: the lane's pairs (a, a + d + 1), independent of
  // the policy, so that the two chains interleave
  float kc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float ppx = __shfl_sync(FULL, s.px, base + part[d]);
    const float ppy = __shfl_sync(FULL, s.py, base + part[d]);
    const float dist = sqrt_k<FAST>(rn_sq2(rn_sub(s.px, ppx), rn_sub(s.py, ppy)), ok);
    const float z = rn_mul(rn_sub(c.dmin, dist), c.invk);
    const float pen = rn_mul(rn_add(fmaxf(z, 0.f), log1pf(expf(-fabsf(z)))), c.margin);
    kc[d] = div_k<FAST>(rn_mul(c.cf, pen), fmaxf(dist, 1e-12f), ok);
  }
  // ---- end of the pair coefficients

  // ---- ezpolicy: this lane's agent's force from the state
  const float mx = mean_k<n, FAST>(s.qx, ok), my = mean_k<n, FAST>(s.qy, ok);
  float cx[n], cy[n];
#pragma unroll
  for (int k = 0; k < n; ++k) {
    cx[k] = rn_sub(s.qx[k], mx);
    cy[k] = rn_sub(s.qy[k], my);
  }
  const float cxo = rn_sub(s.px, mx), cyo = rn_sub(s.py, my);
  // this lane's vertex: its nearest agent, first index on ties
  int closest = 0;
  float cbest = 0.f;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float d = sqrt_k<FAST>(rn_sq2(rn_sub(cx[k], s.sxo), rn_sub(cy[k], s.syo)), ok);
    if (k == 0 || d < cbest) {
      cbest = d;
      closest = k;
    }
  }
  int cl[n];
  gather<n>(closest, base, cl);
  // this lane's agent to each vertex; the farthest, highest index on ties
  float dav[n];
#pragma unroll
  for (int v = 0; v < n; ++v)
    dav[v] = sqrt_k<FAST>(rn_sq2(rn_sub(cxo, s.sx[v]), rn_sub(cyo, s.sy[v])), ok);
  int far = 0;
  float fbest = dav[0];
#pragma unroll
  for (int v = 1; v < n; ++v)
    if (dav[v] >= fbest) {
      fbest = dav[v];
      far = v;
    }
  int pick = 0;
  float pbest = (cl[0] == a || far == 0) ? dav[0] : INFINITY;
#pragma unroll
  for (int v = 1; v < n; ++v) {
    const float m = (cl[v] == a || far == v) ? dav[v] : INFINITY;
    if (m < pbest) {
      pbest = m;
      pick = v;
    }
  }
  float tx = s.sx[0], ty = s.sy[0];
#pragma unroll
  for (int v = 1; v < n; ++v)
    if (pick == v) {
      tx = s.sx[v];
      ty = s.sy[v];
    }
  const float ax = fminf(fmaxf(rn_mul(0.5f, rn_sub(tx, cxo)), -1.f), 1.f);
  const float ay = fminf(fmaxf(rn_mul(0.5f, rn_sub(ty, cyo)), -1.f), 1.f);
  // settled: the current shape's rows in the agent's [others, self] order
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float ox = k == n - 1 ? cxo : (k < a ? cx[k] : cx[k < n - 1 ? k + 1 : k]);
    const float oy = k == n - 1 ? cyo : (k < a ? cy[k] : cy[k < n - 1 ? k + 1 : k]);
    const float e = rn_sq2(rn_sub(s.sx[k], ox), rn_sub(s.sy[k], oy));
    sq = k == 0 ? e : rn_add(sq, e);
  }
  const float coef = sq < 1e-4f ? 1.0f : 0.3f;
  float fx = rn_mul(c.sens, rn_add(ax, rn_mul(s.ivx, coef)));
  float fy = rn_mul(c.sens, rn_add(ay, rn_mul(s.ivy, coef)));
  // ---- end of the policy

  // ---- pairs: each unordered pair's coefficient into the env's matrix,
  // then agent a's terms over j in order
  __syncwarp();  // the previous reads of km are done
#pragma unroll
  for (int d = 0; d < D; ++d) {
    km[a * n + part[d]] = kc[d];
    km[part[d] * n + a] = kc[d];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float k = km[a * n + j];
    if (j != a) {
      fx = rn_add(fx, rn_mul(k, rn_sub(s.px, s.qx[j])));
      fy = rn_add(fy, rn_mul(k, rn_sub(s.py, s.qy[j])));
    }
  }
  // ---- end of the pairs

  o.vx = rn_add(rn_mul(s.vx, c.keep), rn_mul(fx, c.dt));
  o.vy = rn_add(rn_mul(s.vy, c.keep), rn_mul(fy, c.dt));
  o.px = rn_add(s.px, rn_mul(o.vx, c.dt));
  o.py = rn_add(s.py, rn_mul(o.vy, c.dt));
  gather<n>(o.px, base, o.qx);
  gather<n>(o.py, base, o.qy);

  // ---- reward of the stepped state
  float gvx[n], gvy[n], pnx[D], pny[D];
  gather<n>(o.vx, base, gvx);
  gather<n>(o.vy, base, gvy);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    pnx[d] = __shfl_sync(FULL, o.px, base + part[d]);
    pny[d] = __shfl_sync(FULL, o.py, base + part[d]);
  }
  const float nmx = mean_k<n, FAST>(o.qx, ok), nmy = mean_k<n, FAST>(o.qy, ok);
  const float ncxo = rn_sub(o.px, nmx), ncyo = rn_sub(o.py, nmy);
  // squared distances: the agent's row minimum, the vertex's column minimum
  float rmin = 0.f, cmin = 0.f;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float r2 = rn_sq2(rn_sub(ncxo, s.sx[k]), rn_sub(ncyo, s.sy[k]));
    const float c2 =
        rn_sq2(rn_sub(rn_sub(o.qx[k], nmx), s.sxo), rn_sub(rn_sub(o.qy[k], nmy), s.syo));
    rmin = k == 0 ? r2 : fminf(rmin, r2);
    cmin = k == 0 ? c2 : fminf(cmin, c2);
  }
  int hits = 0;
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (2 * (d + 1) < n || a < d + 1)  // at even n, pair (a, a + n/2) from its lower agent only
      hits += rn_sq2(rn_sub(o.px, pnx[d]), rn_sub(o.py, pny[d])) < c.thresh2;
  float h2[n];
  int nh[n];
  gather<n>(fmaxf(rmin, cmin), base, h2);
  gather<n>(hits, base, nh);
  float hmax = h2[0];
  int ncount = nh[0];
#pragma unroll
  for (int k = 1; k < n; ++k) {
    hmax = fmaxf(hmax, h2[k]);
    ncount += nh[k];
  }
  const float haus = sqrt_k<FAST>(hmax, ok);
  const float dvx = rn_sub(s.ivx, mean_k<n, FAST>(gvx, ok));
  const float dvy = rn_sub(s.ivy, mean_k<n, FAST>(gvy, ok));
  const float shared = rn_sub(-haus, sqrt_k<FAST>(rn_sq2(dvx, dvy), ok));
  const float ncoll = (float)(2 * ncount);  // the plain version's sum of 2.0s, exact
  o.rew = rn_mul(rn_sub(rn_mul(shared, fn), ncoll), fn);
  // ---- end of the reward
  return ok;
}

// After step it: the reward into racc, the lane's state to the stepped one,
// the time limit and the auto-reset.  Every lane of the warp must call it.
template <int n>
__device__ __forceinline__ void advance(LaneState<n>& s, const StepOut<n>& o, int& t, float& racc,
                                        int it, bool active, int base, int a, int b, int ep_len,
                                        unsigned seed) {
  racc = rn_add(racc, o.rew);
  s.px = o.px;
  s.py = o.py;
  s.vx = o.vx;
  s.vy = o.vy;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    s.qx[k] = o.qx[k];
    s.qy[k] = o.qy[k];
  }
  const int nt = t + 1;
  const bool done = active && nt >= ep_len;
  t = nt;
  if (__any_sync(FULL, done)) {  // every lane draws: the control flow stays uniform
    const unsigned u = (unsigned)it, key = (unsigned)b;
    const float rx = uniform_pm1(seed, u, a, key), ry = uniform_pm1(seed, u, n + a, key);
    const float lx = uniform_pm1(seed, u, 2 * n + a, key);
    const float ly = uniform_pm1(seed, u, 3 * n + a, key);
    float lxs[n], lys[n], rxs[n], rys[n];
    gather<n>(lx, base, lxs);
    gather<n>(ly, base, lys);
    gather<n>(rx, base, rxs);
    gather<n>(ry, base, rys);
    const float lmx = mean_n<n>(lxs), lmy = mean_n<n>(lys);
    const float rivx = uniform_pm1(seed, u, 4 * n, key), rivy = uniform_pm1(seed, u, 4 * n + 1, key);
    if (done) {
      s.px = rx;
      s.py = ry;
      s.vx = s.vy = 0.f;
#pragma unroll
      for (int k = 0; k < n; ++k) {
        s.qx[k] = rxs[k];
        s.qy[k] = rys[k];
        s.sx[k] = rn_sub(lxs[k], lmx);
        s.sy[k] = rn_sub(lys[k], lmy);
      }
      s.sxo = rn_sub(lx, lmx);
      s.syo = rn_sub(ly, lmy);
      s.ivx = rivx;
      s.ivy = rivy;
      t = 0;
    }
  }
}

template <int n>
__global__ void __launch_bounds__(WARPS * 32) fused_rollout_kernel(
    const float* __restrict__ ap_in, const float* __restrict__ av_in,
    const float* __restrict__ is_in, const float* __restrict__ iv_in,
    const int* __restrict__ t_in, float* __restrict__ ap_out,
    float* __restrict__ av_out, float* __restrict__ is_out,
    float* __restrict__ iv_out, int* __restrict__ t_out,
    float* __restrict__ rew, int B, int T, int ep_len, unsigned seed, Consts c) {
  using L = Lanes<n>;
  __shared__ float kmat[WARPS][L::SLOTS * n * n];  // each env's pair coefficients [n][n]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / n, a = lane - g * n;  // the lane's env of the warp, and agent
  const int base = g * n;                     // the group's first lane
  float* km = kmat[warp] + base * n;
  int part[L::D];  // agent a + d, the partner of the lane's pairs
#pragma unroll
  for (int d = 0; d < L::D; ++d) part[d] = (a + d + 1) % n;

  for (int w = blockIdx.x * WARPS + warp; w * L::G < B; w += gridDim.x * WARPS) {
    const int b = w * L::G + g;
    const bool active = g < L::G && b < B;
    LaneState<n> s = {};
    int t = 0;
    if (active) {
#pragma unroll
      for (int k = 0; k < n; ++k) {
        s.qx[k] = ap_in[(size_t)k * B + b];
        s.qy[k] = ap_in[(size_t)(n + k) * B + b];
        s.sx[k] = is_in[(size_t)k * B + b];
        s.sy[k] = is_in[(size_t)(n + k) * B + b];
      }
      s.px = ap_in[(size_t)a * B + b];
      s.py = ap_in[(size_t)(n + a) * B + b];
      s.vx = av_in[(size_t)a * B + b];
      s.vy = av_in[(size_t)(n + a) * B + b];
      s.sxo = is_in[(size_t)a * B + b];
      s.syo = is_in[(size_t)(n + a) * B + b];
      s.ivx = iv_in[b];
      s.ivy = iv_in[B + b];
      t = t_in[b];
    }
    float racc = 0.f;

    // the fast steps run in an inner loop whose only branch is its
    // warp-uniform exit; a step with an operand out of the fast paths'
    // range runs again on the intrinsics, outside it
    for (int it = 0; it < T;) {
      StepOut<n> o;
      for (; it < T; ++it) {
        const bool ok = env_step<n, true>(s, o, km, a, base, part, c);
        if (!__all_sync(FULL, ok || !active)) break;  // idle lanes hold zeros: out of range
        advance<n>(s, o, t, racc, it, active, base, a, b, ep_len, seed);
      }
      if (it < T) {
        env_step<n, false>(s, o, km, a, base, part, c);
        advance<n>(s, o, t, racc, it, active, base, a, b, ep_len, seed);
        ++it;
      }
    }

    if (active) {
      ap_out[(size_t)a * B + b] = s.px;
      ap_out[(size_t)(n + a) * B + b] = s.py;
      av_out[(size_t)a * B + b] = s.vx;
      av_out[(size_t)(n + a) * B + b] = s.vy;
      is_out[(size_t)a * B + b] = s.sxo;
      is_out[(size_t)(n + a) * B + b] = s.syo;
      if (a == 0) {
        iv_out[b] = s.ivx;
        iv_out[B + b] = s.ivy;
        t_out[b] = t;
        rew[b] = racc;
      }
    }
  }
}

template <int n>
int plan() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_rollout_kernel<n>, WARPS * 32,
                                                    0) != cudaSuccess)
    return -1;
  return blocks;
}

// Whether (n, G envs a warp, threads a block) is an instantiated kernel's plan
bool built(int n, int G, int threads) {
  if (threads != WARPS * 32) return false;
  return (n == 3 && G == Lanes<3>::G) || (n == 4 && G == Lanes<4>::G) ||
         (n == 9 && G == Lanes<9>::G);
}

}  // namespace

// The launch plan of the kernel for n agents, G envs a warp and threads a
// block (the wrapper's launch_plan): the resident blocks an SM; -2 where
// (n, G, threads) is not an instantiated kernel's, -1 on a CUDA error.
extern "C" int fused_rollout_plan(int n, int G, int threads) {
  if (!built(n, G, threads)) return -2;
  if (n == 3) return plan<3>();
  if (n == 4) return plan<4>();
  return plan<9>();
}

// G envs a warp, threads a block and grid blocks: the wrapper's launch plan.
extern "C" int fused_rollout_launch(
    const void* ap, const void* av, const void* ishape, const void* ivel,
    const void* t, void* ap_out, void* av_out, void* is_out, void* iv_out,
    void* t_out, void* rew, int B, int n, int T, int ep_len, int G, int threads,
    int grid, unsigned seed, float sens, float dmin, float thresh2, float cf, float margin,
    float invk, float keep, float dt, void* stream) {
  if (!built(n, G, threads) || grid < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Consts c = {sens, dmin, thresh2, cf, margin, invk, keep, dt};
#define GFT_LAUNCH(N)                                                             \
  fused_rollout_kernel<N><<<grid, threads, 0, s>>>(                               \
      (const float*)ap, (const float*)av, (const float*)ishape,                   \
      (const float*)ivel, (const int*)t, (float*)ap_out, (float*)av_out,          \
      (float*)is_out, (float*)iv_out, (int*)t_out, (float*)rew, B, T, ep_len,     \
      seed, c)
  switch (n) {
    case 3: GFT_LAUNCH(3); break;
    case 4: GFT_LAUNCH(4); break;
    default: GFT_LAUNCH(9); break;
  }
#undef GFT_LAUNCH
  return (int)cudaGetLastError();
}
