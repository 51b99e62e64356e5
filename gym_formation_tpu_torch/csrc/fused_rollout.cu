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
// What bounds it on the H100: latency.  Each step is a few hundred dependent
// FP32 operations per env (at n=3 about 60 pair terms, 9 agent-vertex
// distances twice, the policy's selects) plus, for n^2 ordered pairs, an
// expf and a log1pf; device memory is touched only at the start and end of
// the call (about 26 n bytes per env).  At B=4096 there are only 4096
// threads, so the card is far from full and each step's time is the length
// of one thread's dependency chain.
//
// Design: one thread per env, the whole T-step loop in registers; n is a
// template parameter (3, 4, 9), so every per-agent array is unrolled into
// registers and every loop bound is a constant.  32 threads per block, so
// that B=4096 spreads over 128 of the 132 SMs.  The SoA planes [rows, B]
// make each load and store coalesced.  The reset's random numbers are drawn
// only on the step an env resets: the generator is counter-based, so the
// bits are those of the JAX kernel, which draws them every step.
//
// Exactness: every operation is spelled with rn_* (no contraction into fused
// multiply-adds), in the plain version's order, and the transcendentals are
// the CUDA math library's expf / log1pf / correctly rounded sqrt, which
// PyTorch's CUDA kernels call too: on the card the kernel and the plain
// version agree bit for bit, so a policy comparison never flips between
// them.

#include <math.h>

#include "common.cuh"

// Uniform [-1, 1) keyed by (seed, it, row, lane), as the JAX _uniform_pm1.
__device__ __forceinline__ float uniform_pm1(unsigned seed, unsigned it, unsigned row,
                                             unsigned lane) {
  const unsigned ctr = (seed * 2654435761u) ^ (it * 0x9E3779B9u) ^ (row * 0x27D4EB2Fu);
  const unsigned bits = hash_u32(ctr + lane);
  const float u01 = rn_mul((float)(int)(bits >> 8), 1.0f / 16777216.0f);
  return rn_sub(rn_mul(u01, 2.0f), 1.0f);
}

template <int n>
__global__ void fused_rollout_kernel(
    const float* __restrict__ ap_in, const float* __restrict__ av_in,
    const float* __restrict__ is_in, const float* __restrict__ iv_in,
    const int* __restrict__ t_in, float* __restrict__ ap_out,
    float* __restrict__ av_out, float* __restrict__ is_out,
    float* __restrict__ iv_out, int* __restrict__ t_out,
    float* __restrict__ rew, int B, int T, int ep_len, unsigned seed,
    float sens, float dmin, float thresh2, float cf, float margin, float invk,
    float keep, float dt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float px[n], py[n], vx[n], vy[n], sx[n], sy[n];
#pragma unroll
  for (int a = 0; a < n; ++a) {
    px[a] = ap_in[(size_t)a * B + b];
    py[a] = ap_in[(size_t)(n + a) * B + b];
    vx[a] = av_in[(size_t)a * B + b];
    vy[a] = av_in[(size_t)(n + a) * B + b];
    sx[a] = is_in[(size_t)a * B + b];
    sy[a] = is_in[(size_t)(n + a) * B + b];
  }
  float ivx = iv_in[b], ivy = iv_in[B + b];
  int t = t_in[b];
  float racc = 0.f;
  const float fn = (float)n;

  for (int it = 0; it < T; ++it) {
    // ---- ezpolicy from the state ----------------------------------------
    const float mx = mean_n<n>(px), my = mean_n<n>(py);
    float cx[n], cy[n];
#pragma unroll
    for (int a = 0; a < n; ++a) {
      cx[a] = rn_sub(px[a], mx);
      cy[a] = rn_sub(py[a], my);
    }
    float dav[n][n];  // agent a to ideal vertex v
#pragma unroll
    for (int a = 0; a < n; ++a)
#pragma unroll
      for (int v = 0; v < n; ++v)
        dav[a][v] = __fsqrt_rn(rn_sq2(rn_sub(cx[a], sx[v]), rn_sub(cy[a], sy[v])));
    int closest[n];  // per vertex: the nearest agent, first index on ties
#pragma unroll
    for (int v = 0; v < n; ++v) {
      float best = dav[0][v];
      int idx = 0;
#pragma unroll
      for (int a = 1; a < n; ++a)
        if (dav[a][v] < best) {
          best = dav[a][v];
          idx = a;
        }
      closest[v] = idx;
    }
    float fx[n], fy[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      int far = 0;  // farthest vertex, highest index on ties
      float fbest = dav[i][0];
#pragma unroll
      for (int v = 1; v < n; ++v)
        if (dav[i][v] >= fbest) {
          fbest = dav[i][v];
          far = v;
        }
      int pick = 0;
      float pbest = (closest[0] == i || far == 0) ? dav[i][0] : INFINITY;
#pragma unroll
      for (int v = 1; v < n; ++v) {
        const float m = (closest[v] == i || far == v) ? dav[i][v] : INFINITY;
        if (m < pbest) {
          pbest = m;
          pick = v;
        }
      }
      float tx = sx[0], ty = sy[0];
#pragma unroll
      for (int v = 1; v < n; ++v)
        if (pick == v) {
          tx = sx[v];
          ty = sy[v];
        }
      const float ax = fminf(fmaxf(rn_mul(0.5f, rn_sub(tx, cx[i])), -1.f), 1.f);
      const float ay = fminf(fmaxf(rn_mul(0.5f, rn_sub(ty, cy[i])), -1.f), 1.f);
      // settled: the current shape's rows in the agent's [others, self] order
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < n; ++k) {
        const int a = k < n - 1 ? (k < i ? k : k + 1) : i;
        const float e = rn_sq2(rn_sub(sx[k], cx[a]), rn_sub(sy[k], cy[a]));
        sq = k == 0 ? e : rn_add(sq, e);
      }
      const float coef = sq < 1e-4f ? 1.0f : 0.3f;
      fx[i] = rn_mul(sens, rn_add(ax, rn_mul(ivx, coef)));
      fy[i] = rn_mul(sens, rn_add(ay, rn_mul(ivy, coef)));
    }

    // ---- physics among the agents (mass 1) -------------------------------
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        if (i == j) continue;
        const float dx = rn_sub(px[i], px[j]), dy = rn_sub(py[i], py[j]);
        const float dist = __fsqrt_rn(rn_sq2(dx, dy));
        const float z = rn_mul(rn_sub(dmin, dist), invk);
        const float pen = rn_mul(rn_add(fmaxf(z, 0.f), log1pf(expf(-fabsf(z)))), margin);
        const float k = rn_div(rn_mul(cf, pen), fmaxf(dist, 1e-12f));
        fx[i] = rn_add(fx[i], rn_mul(k, dx));
        fy[i] = rn_add(fy[i], rn_mul(k, dy));
      }
    float nvx[n], nvy[n], npx[n], npy[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      nvx[i] = rn_add(rn_mul(vx[i], keep), rn_mul(fx[i], dt));
      nvy[i] = rn_add(rn_mul(vy[i], keep), rn_mul(fy[i], dt));
      npx[i] = rn_add(px[i], rn_mul(nvx[i], dt));
      npy[i] = rn_add(py[i], rn_mul(nvy[i], dt));
    }

    // ---- reward of the stepped state -------------------------------------
    const float nmx = mean_n<n>(npx), nmy = mean_n<n>(npy);
    float ncx[n], ncy[n];
#pragma unroll
    for (int a = 0; a < n; ++a) {
      ncx[a] = rn_sub(npx[a], nmx);
      ncy[a] = rn_sub(npy[a], nmy);
    }
    float rmax = 0.f, cmax = 0.f;
    float colmin[n];
#pragma unroll
    for (int a = 0; a < n; ++a) {
      float rmin = 0.f;
#pragma unroll
      for (int v = 0; v < n; ++v) {
        const float d = __fsqrt_rn(rn_sq2(rn_sub(ncx[a], sx[v]), rn_sub(ncy[a], sy[v])));
        rmin = v == 0 ? d : fminf(rmin, d);
        colmin[v] = a == 0 ? d : fminf(colmin[v], d);
      }
      rmax = a == 0 ? rmin : fmaxf(rmax, rmin);
    }
#pragma unroll
    for (int v = 0; v < n; ++v) cmax = v == 0 ? colmin[v] : fmaxf(cmax, colmin[v]);
    const float haus = fmaxf(rmax, cmax);
    const float dvx = rn_sub(ivx, mean_n<n>(nvx)), dvy = rn_sub(ivy, mean_n<n>(nvy));
    const float shared = rn_sub(-haus, __fsqrt_rn(rn_sq2(dvx, dvy)));
    float ncoll = 0.f;
#pragma unroll
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int j = i + 1; j < n; ++j)
        if (rn_sq2(rn_sub(npx[i], npx[j]), rn_sub(npy[i], npy[j])) < thresh2) ncoll += 2.f;
    racc = rn_add(racc, rn_mul(rn_sub(rn_mul(shared, fn), ncoll), fn));

    // ---- time limit and auto-reset ---------------------------------------
    const int nt = t + 1;
    if (nt >= ep_len) {
      const unsigned u = (unsigned)it, lane = (unsigned)b;
      float lx[n], ly[n];
#pragma unroll
      for (int a = 0; a < n; ++a) {
        px[a] = uniform_pm1(seed, u, a, lane);
        py[a] = uniform_pm1(seed, u, n + a, lane);
        lx[a] = uniform_pm1(seed, u, 2 * n + a, lane);
        ly[a] = uniform_pm1(seed, u, 3 * n + a, lane);
        vx[a] = 0.f;
        vy[a] = 0.f;
      }
      const float lmx = mean_n<n>(lx), lmy = mean_n<n>(ly);
#pragma unroll
      for (int a = 0; a < n; ++a) {
        sx[a] = rn_sub(lx[a], lmx);
        sy[a] = rn_sub(ly[a], lmy);
      }
      ivx = uniform_pm1(seed, u, 4 * n, lane);
      ivy = uniform_pm1(seed, u, 4 * n + 1, lane);
      t = 0;
    } else {
#pragma unroll
      for (int a = 0; a < n; ++a) {
        px[a] = npx[a];
        py[a] = npy[a];
        vx[a] = nvx[a];
        vy[a] = nvy[a];
      }
      t = nt;
    }
  }

#pragma unroll
  for (int a = 0; a < n; ++a) {
    ap_out[(size_t)a * B + b] = px[a];
    ap_out[(size_t)(n + a) * B + b] = py[a];
    av_out[(size_t)a * B + b] = vx[a];
    av_out[(size_t)(n + a) * B + b] = vy[a];
    is_out[(size_t)a * B + b] = sx[a];
    is_out[(size_t)(n + a) * B + b] = sy[a];
  }
  iv_out[b] = ivx;
  iv_out[B + b] = ivy;
  t_out[b] = t;
  rew[b] = racc;
}

extern "C" int fused_rollout_launch(
    const void* ap, const void* av, const void* ishape, const void* ivel,
    const void* t, void* ap_out, void* av_out, void* is_out, void* iv_out,
    void* t_out, void* rew, int B, int n, int T, int ep_len, unsigned seed,
    float sens, float dmin, float thresh2, float cf, float margin, float invk,
    float keep, float dt, void* stream) {
  if (B == 0) return 0;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define GFT_LAUNCH(N)                                                             \
  fused_rollout_kernel<N><<<blocks, threads, 0, s>>>(                             \
      (const float*)ap, (const float*)av, (const float*)ishape,                   \
      (const float*)ivel, (const int*)t, (float*)ap_out, (float*)av_out,          \
      (float*)is_out, (float*)iv_out, (int*)t_out, (float*)rew, B, T, ep_len,     \
      seed, sens, dmin, thresh2, cf, margin, invk, keep, dt)
  switch (n) {
    case 3: GFT_LAUNCH(3); break;
    case 4: GFT_LAUNCH(4); break;
    case 9: GFT_LAUNCH(9); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GFT_LAUNCH
  return (int)cudaGetLastError();
}
