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
// What bounds it on the H100: the MLPs.  At n=3 a step is about 3 * 5,300
// actor and 7,600 critic multiply-adds per env against a few hundred
// operations of physics and reward, and the trajectory write is 70 floats
// per env and step.  Weights (13,000 floats at n=3) are read once per block.
//
// Design: one block of 64 threads per env, ENVS envs per block, every weight
// in shared memory (dynamic, above 48 KB; [in][out] for the first two layers
// so that thread o reads column o without bank conflicts).  Thread o owns
// hidden unit o of every layer: each layer is a running sum over its inputs,
// in order, then the bias, then the relu.  The 2n action means and the value
// are 64-term sums taken by 2n + 1 threads.  Thread 0 of the env holds the
// env's state in registers across the T-step loop and runs the sampling's
// log-density, the physics, the reward and the reset; threads 0..2n-1 draw
// the normals.  The reset's numbers are drawn only on the step an env resets
// (the generator is counter-based, so the bits are those of the JAX kernel,
// which draws them every step).
//
// Exactness: every operation is rounded on its own (rn_*: no contraction into
// fused multiply-adds), in the plain version's order, with the CUDA math
// library's logf / cosf / expf / log1pf and correctly rounded sqrt, as
// PyTorch's own CUDA kernels call them, so the card's kernel and the plain
// version agree bit for bit.  The collision counts decide the reward, so
// their predicate is rounded step by step as K2's is.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int H = 64;     // hidden width of both MLPs
constexpr int ENVS = 4;   // envs per block
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

template <int n>
struct Dims {
  static constexpr int DO = 6 * n;   // one agent's observation
  static constexpr int DC = n * DO;  // the critic's input
  static constexpr int A = 2 * n;    // actions of one env
  // weights and biases in shared memory
  static constexpr int W = DO * H + H + H * H + H + 2 * H + 2 + DC * H + H + H * H + H + H + 1;
  // per-env scratch: obs, normals, actions, h1, h2 (n agents), k1, k2
  static constexpr int S = DC + A + A + 2 * n * H + 2 * H;
  static constexpr size_t SMEM = (size_t)(W + ENVS * S) * sizeof(float);
};

struct Weights {
  const float *aw1, *ab1, *aw2, *ab2, *aw3, *ab3, *als;
  const float *cw1, *cb1, *cw2, *cb2, *cw3, *cb3;
};

struct Traj {
  float *obs, *act, *logp, *val, *rew;
  unsigned char* done;
};

template <int n>
__global__ void __launch_bounds__(ENVS * H) fused_collect_kernel(
    const float* __restrict__ ap_in, const float* __restrict__ av_in,
    const float* __restrict__ is_in, const float* __restrict__ iv_in,
    const int* __restrict__ t_in, Weights g, float* __restrict__ ap_out,
    float* __restrict__ av_out, float* __restrict__ is_out, float* __restrict__ iv_out,
    int* __restrict__ t_out, Traj tr, int B, int T, int ep_len, unsigned seed, float sens,
    float dmin, float thresh2, float cf, float margin, float invk, float keep, float dt) {
  using D = Dims<n>;
  constexpr int DO = D::DO, DC = D::DC, A = D::A;
  extern __shared__ float smem[];
  float* aw1 = smem;          // [DO][H]
  float* ab1 = aw1 + DO * H;  // [H]
  float* aw2 = ab1 + H;       // [H][H], [in][out]
  float* ab2 = aw2 + H * H;
  float* aw3 = ab2 + H;       // [2][H], [out][in]
  float* ab3 = aw3 + 2 * H;   // [2]
  float* cw1 = ab3 + 2;       // [DC][H]
  float* cb1 = cw1 + DC * H;
  float* cw2 = cb1 + H;       // [H][H], [in][out]
  float* cb2 = cw2 + H * H;
  float* cw3 = cb2 + H;       // [H]
  float* cb3 = cw3 + H;       // [1]

  // weights arrive [out][in]; the first two layers are stored [in][out]
  for (int i = threadIdx.x; i < DO * H; i += blockDim.x) aw1[i] = g.aw1[(i % H) * DO + i / H];
  for (int i = threadIdx.x; i < DC * H; i += blockDim.x) cw1[i] = g.cw1[(i % H) * DC + i / H];
  for (int i = threadIdx.x; i < H * H; i += blockDim.x) {
    aw2[i] = g.aw2[(i % H) * H + i / H];
    cw2[i] = g.cw2[(i % H) * H + i / H];
  }
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    ab1[i] = g.ab1[i];
    ab2[i] = g.ab2[i];
    cb1[i] = g.cb1[i];
    cb2[i] = g.cb2[i];
    cw3[i] = g.cw3[i];
    aw3[i] = g.aw3[i];
    aw3[H + i] = g.aw3[H + i];
  }
  if (threadIdx.x < 2) ab3[threadIdx.x] = g.ab3[threadIdx.x];
  if (threadIdx.x == 0) cb3[0] = g.cb3[0];

  const int e = threadIdx.x / H, o = threadIdx.x % H;
  float* obs_s = cb3 + 1 + e * D::S;  // [n][DO]
  float* z_s = obs_s + DC;            // [A]
  float* act_s = z_s + A;             // [A]
  float* h1_s = act_s + A;            // [n][H]
  float* h2_s = h1_s + n * H;         // [n][H]
  float* k1_s = h2_s + n * H;         // [H]
  float* k2_s = k1_s + H;             // [H]
  const int b = blockIdx.x * ENVS + e;
  const bool valid = b < B;
  const bool leader = valid && o == 0;

  const float ls0 = g.als[0], ls1 = g.als[1];
  const float std0 = expf(ls0), std1 = expf(ls1);
  const float ls_sum = rn_add(ls0, ls1);

  float px[n], py[n], vx[n], vy[n], sx[n], sy[n], ivx = 0.f, ivy = 0.f;
  int t = 0;
  if (leader) {
#pragma unroll
    for (int a = 0; a < n; ++a) {
      px[a] = ap_in[(size_t)a * B + b];
      py[a] = ap_in[(size_t)(n + a) * B + b];
      vx[a] = av_in[(size_t)a * B + b];
      vy[a] = av_in[(size_t)(n + a) * B + b];
      sx[a] = is_in[(size_t)a * B + b];
      sy[a] = is_in[(size_t)(n + a) * B + b];
    }
    ivx = iv_in[b];
    ivy = iv_in[B + b];
    t = t_in[b];
  }
  __syncthreads();  // weights in place

  for (int it = 0; it < T; ++it) {
    const size_t row = (size_t)it * B + b;  // (step, env) row of the trajectory
    // ---- observations (leader) and the policy's normals --------------------
    if (leader) {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        float* ob = obs_s + i * DO;
        ob[0] = vx[i];
        ob[1] = vy[i];
        int k = 2;
#pragma unroll
        for (int j = 0; j < n; ++j) {
          if (j == i) continue;
          ob[k++] = rn_sub(px[j], px[i]);
          ob[k++] = rn_sub(py[j], py[i]);
        }
#pragma unroll
        for (int c = 0; c < 2 * (n - 1); ++c) ob[k++] = 0.f;  // silent agents
#pragma unroll
        for (int v = 0; v < n; ++v) {
          ob[k++] = sx[v];
          ob[k++] = sy[v];
        }
        ob[k++] = ivx;
        ob[k] = ivy;
      }
    }
    if (valid && o < A) z_s[o] = normal(seed, (unsigned)it, (unsigned)o, 1u, (unsigned)b);
    __syncthreads();

    // ---- first layers ------------------------------------------------------
    if (valid) {
      for (int idx = o; idx < DC; idx += H) tr.obs[row * DC + idx] = obs_s[idx];
      float acc[n];
#pragma unroll
      for (int i = 0; i < n; ++i) acc[i] = rn_mul(aw1[o], obs_s[i * DO]);
      for (int k = 1; k < DO; ++k) {
        const float w = aw1[k * H + o];
#pragma unroll
        for (int i = 0; i < n; ++i) acc[i] = rn_add(acc[i], rn_mul(w, obs_s[i * DO + k]));
      }
#pragma unroll
      for (int i = 0; i < n; ++i) h1_s[i * H + o] = fmaxf(rn_add(acc[i], ab1[o]), 0.f);
      float c = rn_mul(cw1[o], obs_s[0]);
      for (int k = 1; k < DC; ++k) c = rn_add(c, rn_mul(cw1[k * H + o], obs_s[k]));
      k1_s[o] = fmaxf(rn_add(c, cb1[o]), 0.f);
    }
    __syncthreads();

    // ---- second layers -----------------------------------------------------
    if (valid) {
      float acc[n];
#pragma unroll
      for (int i = 0; i < n; ++i) acc[i] = rn_mul(aw2[o], h1_s[i * H]);
      float c = rn_mul(cw2[o], k1_s[0]);
      for (int k = 1; k < H; ++k) {
        const float w = aw2[k * H + o];
#pragma unroll
        for (int i = 0; i < n; ++i) acc[i] = rn_add(acc[i], rn_mul(w, h1_s[i * H + k]));
        c = rn_add(c, rn_mul(cw2[k * H + o], k1_s[k]));
      }
#pragma unroll
      for (int i = 0; i < n; ++i) h2_s[i * H + o] = fmaxf(rn_add(acc[i], ab2[o]), 0.f);
      k2_s[o] = fmaxf(rn_add(c, cb2[o]), 0.f);
    }
    __syncthreads();

    // ---- heads: action means + sample, value -------------------------------
    if (valid && o < A) {
      const int i = o >> 1, d = o & 1;
      const float* w = aw3 + d * H;
      const float* h = h2_s + i * H;
      float m = rn_mul(w[0], h[0]);
      for (int k = 1; k < H; ++k) m = rn_add(m, rn_mul(w[k], h[k]));
      m = rn_add(m, ab3[d]);
      const float a = rn_add(m, rn_mul(d ? std1 : std0, z_s[o]));
      act_s[o] = a;
      tr.act[row * A + o] = a;
    } else if (valid && o == A) {
      float v = rn_mul(cw3[0], k2_s[0]);
      for (int k = 1; k < H; ++k) v = rn_add(v, rn_mul(cw3[k], k2_s[k]));
      tr.val[row] = rn_add(v, cb3[0]);
    }
    __syncthreads();

    // ---- log-density, physics, reward, reset (leader) ----------------------
    if (leader) {
      const float fn = (float)n;
      float fx[n], fy[n];
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float z0 = z_s[2 * i], z1 = z_s[2 * i + 1];
        const float q = rn_mul(-0.5f, rn_add(rn_mul(z0, z0), rn_mul(z1, z1)));
        tr.logp[row * n + i] = rn_sub(rn_sub(q, ls_sum), LOG_2PI);
        fx[i] = rn_mul(sens, act_s[2 * i]);
        fy[i] = rn_mul(sens, act_s[2 * i + 1]);
      }
      // physics among the agents (mass 1)
#pragma unroll
      for (int i = 0; i < n; ++i)
#pragma unroll
        for (int j = 0; j < n; ++j) {
          if (i == j) continue;
          const float dx = rn_sub(px[i], px[j]), dy = rn_sub(py[i], py[j]);
          const float dist = __fsqrt_rn(rn_sq2(dx, dy));
          const float zz = rn_mul(rn_sub(dmin, dist), invk);
          const float pen = rn_mul(rn_add(fmaxf(zz, 0.f), log1pf(expf(-fabsf(zz)))), margin);
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
      // reward of the stepped state: n * shared - collisions
      const float nmx = mean_n<n>(npx), nmy = mean_n<n>(npy);
      float ncx[n], ncy[n];
#pragma unroll
      for (int a = 0; a < n; ++a) {
        ncx[a] = rn_sub(npx[a], nmx);
        ncy[a] = rn_sub(npy[a], nmy);
      }
      float rmax = 0.f, cmax = 0.f, colmin[n];
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
      tr.rew[row] = rn_sub(rn_mul(shared, fn), ncoll);

      // time limit and auto-reset
      const int nt = t + 1;
      const bool done = nt >= ep_len;
      tr.done[row] = done ? 1 : 0;
      if (done) {
        const unsigned u = (unsigned)it, lane = (unsigned)b;
        auto draw = [&](int r) { return rn_sub(rn_mul(uniform01(seed, u, r, 3u, lane), 2.0f), 1.0f); };
        float lx[n], ly[n];
#pragma unroll
        for (int a = 0; a < n; ++a) {
          px[a] = draw(a);
          py[a] = draw(n + a);
          lx[a] = draw(2 * n + a);
          ly[a] = draw(3 * n + a);
          vx[a] = 0.f;
          vy[a] = 0.f;
        }
        const float lmx = mean_n<n>(lx), lmy = mean_n<n>(ly);
#pragma unroll
        for (int a = 0; a < n; ++a) {
          sx[a] = rn_sub(lx[a], lmx);
          sy[a] = rn_sub(ly[a], lmy);
        }
        ivx = draw(4 * n);
        ivy = draw(4 * n + 1);
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
    __syncthreads();  // obs_s, z_s and act_s are rewritten by the next step
  }

  if (leader) {
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
  }
}

template <int n>
int launch(const void* const* in, const Weights& w, void* const* out, const Traj& tr, int B,
           int T, int ep_len, unsigned seed, const float* c, cudaStream_t s) {
  const size_t smem = Dims<n>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(fused_collect_kernel<n>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + ENVS - 1) / ENVS;
  fused_collect_kernel<n><<<blocks, ENVS * H, smem, s>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const int*)in[4], w, (float*)out[0], (float*)out[1], (float*)out[2], (float*)out[3],
      (int*)out[4], tr, B, T, ep_len, seed, c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_collect_launch(
    const void* ap, const void* av, const void* ishape, const void* ivel, const void* t,
    const void* aw1, const void* ab1, const void* aw2, const void* ab2, const void* aw3,
    const void* ab3, const void* als, const void* cw1, const void* cb1, const void* cw2,
    const void* cb2, const void* cw3, const void* cb3, void* ap_out, void* av_out,
    void* is_out, void* iv_out, void* t_out, void* obs, void* act, void* logp, void* val,
    void* rew, void* done, int B, int n, int T, int ep_len, unsigned seed, float sens,
    float dmin, float thresh2, float cf, float margin, float invk, float keep, float dt,
    void* stream) {
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
  switch (n) {
    case 3: return launch<3>(in, w, out, tr, B, T, ep_len, seed, c, s);
    case 4: return launch<4>(in, w, out, tr, B, T, ep_len, seed, c, s);
    case 9: return launch<9>(in, w, out, tr, B, T, ep_len, seed, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
