// K9: one PPO epoch's full actor + critic gradient, forward and hand-derived
// backward.
//
// Replaces gym_formation_tpu/ops/pallas/fused_ppo_grad.py:fused_ppo_grads
// (the _grad_kernel Pallas kernel).  Same function as the plain version
// gym_formation_tpu_torch/ops/kernels/fused_ppo_grad.py:fused_ppo_grads_plain:
// the shared GaussianActor on every (sample, agent) row and the centralized
// ValueCritic on every sample row, the clipped-ratio policy loss with the
// +-20 log-ratio clamp (min's tie to the clipped term), the clipped Huber
// value loss (max's tie to the clipped term), the gradient of every weight,
// bias and bounded log-std, and the sums of the three metrics.  The entropy
// term and the soft_bound chain stay with the caller.
//
// What bounds it on the H100: FP32 arithmetic.  At the training shape
// (M = 25 * 4096 sample rows, n = 3: 307,200 actor rows of 18 and 102,400
// critic rows of 54) an epoch is 6.59 G multiply-adds: the forward, the
// weight gradients and the input gradients g2 = gh W3^T, g1 = g2 W2^T; the
// data read is 40 MB.  Tensor cores are not used: TF32 keeps about three
// digits, and the gradient sums over 307,200 rows are held to rtol 2e-3
// against f32.
//
// Design: two launches of one kernel, the actor's and the critic's, each a
// single persistent wave (as many blocks as fit on the card, by
// fused_ppo_grad_plan: two an SM at most 128 registers a thread where
// K <= 64, shared memory sized for the role); block b walks the 64-row
// chunks b, b + G, ... and keeps every gradient entry it owns in registers
// for its whole life: thread (ty, tx) of 16 x 16 owns dW2[4ty..+4][4tx..+4],
// dW1[ty + 16j][4tx..+4] and the partial column sums of db1, db2, dW3 over
// its rows; it writes its slice of a [G, P] buffer once, and
// slice_sum_kernel sums the slices over the blocks in a fixed order.  Rows
// wider than 128 floats (the critic's from n=5 on) take dW1 in groups of 128
// rows a chunk, each group's sums added into the block's slice in device
// memory.  Per chunk (the chunk's inputs, x transposed into x^T, and per-row
// scalars arrive by cp.async, issued while the previous chunk computes;
// where two stages would keep a block off the SM, as for the critic's rows
// of 54 at n=3, one stage, refilled after the chunk):
//   1. h1 = relu(x W1 + b1)      A: x^T rows, B: W1 rows from global (L1)
//   2. h2 = relu(h1 W2 + b2)     A: h1^T rows, B: W2 rows
//      heads h2 W3 in the epilogue, reduced by shuffles over the 16 lanes
//      that share a row; lane tx computes the loss terms of row tx % 4 of
//      its four and the lanes take the rows' dL/dhead by shuffles; dW3, db2
//      and g2 = (gh W3^T) * (h2 > 0) from the thread's own tile
//   3. dW2 += h1^T g2            A: h1 rows, B: g2 rows
//      g1 = (g2 W2^T) * (h1 > 0) A: g2^T rows, B: W2^T rows
//   4. dW1 += x^T g1             A: x^T rows, 4 rows a step, B: g1 rows;
//      the rows k >= K of the dW1 tiles are skipped, a warp at a time
// Every product is a 4 x 4 register tile whose operands are 16-byte shared
// loads (LDS.128): each activation is written twice, row-major and
// transposed, so that both products reading it get contiguous fragments; a
// transposed buffer is swizzled by 16-byte granules (granule ty ^ (k / 4))
// so that its column-wise writes do not hit one bank, and x^T is padded to
// rows of 68.  Four barriers a chunk.  No atomics: the result does not
// depend on scheduling, and two runs agree bit for bit.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int H = 64;    // hidden width
constexpr int R = 64;    // rows per chunk
constexpr int NT = 256;  // threads per block: a 16 x 16 grid of 4 x 4 tiles
constexpr int XS = R + 4;  // row stride of a stage's x^T [K][XS]: rows 4 apart in other banks
constexpr int SMALL = 4 * H + 4;  // b1, b2, W3 [H][2], b3 [2], log-std [2]
constexpr float LOG_2PI = 1.8378770664093453f;

struct Role {
  const float* x;    // [rows][K]
  const float* act;  // actor: actions [rows][A]
  const float* s0;   // actor: logp_old; critic: v_old   [rows]
  const float* s1;   // actor: advantage; critic: target [rows]
  const float *w1, *b1, *w2, *b2, *w3, *b3, *ls;
  float* part;  // [G][P]
  int rows, K, A, G, stages;
  float clip_eps, huber_delta, value_coef, inv_rows;
};

// Shared floats of a block: W2, W2^T, h1, h1^T (later g1), g2, g2^T, the
// small operands, and one or two stages of x^T [K][XS] and the per-row
// scalars [R][4].
__host__ __device__ inline int smem_floats(int K, int stages) {
  return 6 * H * H + SMALL + stages * (K * XS + R * 4);
}

// Layout of a block's gradient slice: dW1 [K][H], db1, dW2 [H][H], db2,
// dW3 [H][A], db3 [A], then (actor) dlog_std [A], pg sum, kl sum or
// (critic) the value-loss sum.
__host__ __device__ inline int slice_len(int K, int A, bool actor) {
  return K * H + H + H * H + H + H * A + A + (actor ? A + 2 : 1);
}

// Index of element (k, 4 g) of a transposed [H][R] buffer, granule-swizzled.
__device__ __forceinline__ int swz(int k, int g) { return k * R + 4 * (g ^ ((k >> 2) & 15)); }

__device__ __forceinline__ float huber(float e, float delta) {
  const float a = fabsf(e);
  return a <= delta ? 0.5f * e * e : delta * (a - 0.5f * delta);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Where a thread's copies of x land: element i = tid + n NT of a chunk is
// (row, col) = (i / K, i % K), walked without a division.
struct XWalk {
  int row0, col0, drow, dcol;
};

// Issue the copies of chunk c's x rows (transposed, into x^T [K][XS]) and
// per-row scalars into one stage (rows past the end are zero-filled), as
// one cp.async group.
template <bool ACTOR>
__device__ void stage(const Role& g, const XWalk& w, float* xt, float* rq, int c) {
  const int r0 = c * R, K = g.K;
  const int nv = min(R, g.rows - r0) * K;  // valid floats of x
  const float* xsrc = g.x + (size_t)r0 * K;
  int row = w.row0, col = w.col0;
  for (int i = threadIdx.x; i < R * K; i += NT) {
    cp_async4(xt + col * XS + row, i < nv ? xsrc + i : g.x, i < nv);
    row += w.drow;
    col += w.dcol;
    if (col >= K) {
      col -= K;
      ++row;
    }
  }
  for (int i = threadIdx.x; i < R * 4; i += NT) {
    const int row = r0 + (i >> 2), q = i & 3;
    const float* src = nullptr;
    if (row < g.rows) {
      if (ACTOR)
        src = q < g.A ? g.act + (size_t)row * g.A + q : q == 2 ? g.s0 + row : q == 3 ? g.s1 + row : nullptr;
      else
        src = q == 0 ? g.s0 + row : q == 1 ? g.s1 + row : nullptr;
    }
    cp_async4(rq + i, src ? src : g.x, src != nullptr);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void fma44(float (&acc)[4][4], const float (&a)[4], const float4& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
  }
}
__device__ __forceinline__ void fma44(float (&acc)[4][4], const float4& a, const float4& b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  fma44(acc, av, b);
}
__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc += A B over k < H: A's rows 4 ty..+4 from a swizzled transposed buffer
// at [H][R], B's columns 4 tx..+4 from a row-major [H][H] buffer b.  Sixteen
// k a step: (k >> 2) & 15 = (k0 >> 2) | (kk >> 2), so the swizzle is one
// XOR a step and an immediate offset a k.
__device__ __forceinline__ void mm_t(float (&acc)[4][4], const float* at, const float* b, int ty,
                                     int tx) {
#pragma unroll 1
  for (int k0 = 0; k0 < H; k0 += 16) {
    const int t0 = ty ^ (k0 >> 2);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk)
      fma44(acc, ld4(at + (k0 + kk) * R + 4 * (t0 ^ (kk >> 2))), ld4(b + (k0 + kk) * H + 4 * tx));
  }
}

// KR: dW1 rows a thread owns (ty + 16 j, j < KR): K <= 16 KR, or any K where
// WIDE (dW1 in groups of 16 KR rows, summed in the slice chunk by chunk).
template <bool ACTOR, int KR, bool WIDE>
__global__ void __launch_bounds__(NT, KR <= 4 ? 2 : 1) ppo_grad_kernel(Role g) {
  extern __shared__ __align__(16) float sm[];
  float* w2 = sm;            // [H][H]
  float* w2t = w2 + H * H;   // [H][H]: W2^T
  float* h1 = w2t + H * H;   // [R][H]
  float* h1t = h1 + R * H;   // [H][R] swizzled: h1^T; then g1 [R][H]
  float* g2 = h1t + H * R;   // [R][H]
  float* g2t = g2 + R * H;   // [H][R] swizzled
  float* b1 = g2t + H * R;
  float* b2 = b1 + H;
  float* w3 = b2 + H;  // [H][A]
  float* b3 = w3 + 2 * H;
  float* ls = b3 + 2;
  const int K = g.K, A = ACTOR ? g.A : 1;
  float* xs = sm + 6 * H * H + SMALL;  // [stages][K][XS]: x^T
  float* rqs = xs + g.stages * K * XS;  // [stages][R][4]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, lane = tid & 31;
  const XWalk walk = {tid / K, tid % K, NT / K, NT % K};

  for (int i = tid; i < H * H; i += NT) {
    const float w = g.w2[i];
    w2[i] = w;
    w2t[(i % H) * H + i / H] = w;
  }
  for (int i = tid; i < H; i += NT) {
    b1[i] = g.b1[i];
    b2[i] = g.b2[i];
  }
  for (int i = tid; i < H * A; i += NT) w3[i] = g.w3[i];
  if (tid < A) {
    b3[tid] = g.b3[tid];
    if (ACTOR) ls[tid] = g.ls[tid];
  }
  if (blockIdx.x * R < g.rows) stage<ACTOR>(g, walk, xs, rqs, blockIdx.x);
  __syncthreads();

  // per-thread constants: W3 rows of the thread's columns, the log-std terms
  float w3r[4][2], inv_std[2] = {0.f, 0.f}, ls_sum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int d = 0; d < 2; ++d) w3r[j][d] = d < A ? w3[(4 * tx + j) * A + d] : 0.f;
  if (ACTOR)
#pragma unroll
    for (int d = 0; d < 2; ++d)
      if (d < A) {
        inv_std[d] = expf(-ls[d]);
        ls_sum += ls[d];
      }

  // the block's gradient entries, in registers for its whole life
  float aW2[4][4], aW1[KR][4], ab1[4], ab2[4], aW3[4][2];
  float t_b3[2] = {0.f, 0.f}, t_ls[2] = {0.f, 0.f}, t_pg = 0.f, t_kl = 0.f;  // lanes tx < 4
  zero44(aW2);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ab1[j] = ab2[j] = aW3[j][0] = aW3[j][1] = 0.f;
#pragma unroll
    for (int q = 0; q < KR; ++q) aW1[q][j] = 0.f;
  }

  int buf = 0;
  for (int c = blockIdx.x; c * R < g.rows; c += g.G) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // this chunk's inputs landed; the previous chunk's reads are done
    const bool more = (c + g.G) * R < g.rows;
    if (g.stages == 2 && more)  // the next chunk's copies run under this chunk
      stage<ACTOR>(g, walk, xs + (buf ^ 1) * K * XS, rqs + (buf ^ 1) * R * 4, c + g.G);
    const float* x = xs + buf * K * XS;  // x^T
    const float* rq = rqs + buf * R * 4;
    const int r0 = c * R;
    float acc[4][4];

    // ---- 1. h1 = relu(x W1 + b1) ----
    zero44(acc);
#pragma unroll 2
    for (int k = 0; k < K; ++k)
      fma44(acc, ld4(x + k * XS + 4 * ty),
            __ldg(reinterpret_cast<const float4*>(g.w1 + k * H + 4 * tx)));
    unsigned m1 = 0;  // bit 4 i + j: h1 > 0
    {
      const float4 bb = ld4(b1 + 4 * tx);
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaxf(acc[i][j] + bv[j], 0.f);
          m1 |= (acc[i][j] > 0.f ? 1u : 0u) << (4 * i + j);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) st4(h1 + (4 * ty + i) * H + 4 * tx, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) st4(h1t + swz(4 * tx + j, ty), acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    __syncthreads();

    // ---- 2. h2 = relu(h1 W2 + b2), heads, loss terms, g2 ----
    zero44(acc);
    mm_t(acc, h1t, w2, ty, tx);
    float gh[4][2];
    {
      const float4 bb = ld4(b2 + 4 * tx);
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
      float head[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        head[i][0] = head[i][1] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaxf(acc[i][j] + bv[j], 0.f);
          head[i][0] = fmaf(acc[i][j], w3r[j][0], head[i][0]);
          if (ACTOR) head[i][1] = fmaf(acc[i][j], w3r[j][1], head[i][1]);
        }
      }
      // the 16 lanes of a row group (same ty) hold its 64 columns
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          head[i][0] += __shfl_xor_sync(0xffffffffu, head[i][0], o);
          if (ACTOR) head[i][1] += __shfl_xor_sync(0xffffffffu, head[i][1], o);
        }
      // row io = tx % 4 of the group's four: its loss terms (lanes tx, tx ^ 4,
      // tx ^ 8, tx ^ 12 compute them alike; lane tx = io adds the sums)
      const int io = tx & 3;
      float hv[2] = {head[0][0], head[0][1]};
#pragma unroll
      for (int i = 1; i < 4; ++i)
        if (io == i) {
          hv[0] = head[i][0];
          hv[1] = head[i][1];
        }
      const bool valid = r0 + 4 * ty + io < g.rows;
      const bool adds = tx < 4 && valid;
      const float4 q = ld4(rq + 4 * (4 * ty + io));
      float go[2] = {0.f, 0.f};  // dL/dhead of row io
      if (ACTOR) {
        float z[2] = {0.f, 0.f}, zz = 0.f;
#pragma unroll
        for (int d = 0; d < 2; ++d)
          if (d < A) {
            const float mu = hv[d] + b3[d];
            z[d] = valid ? ((d == 0 ? q.x : q.y) - mu) * inv_std[d] : 0.f;
            zz += z[d] * z[d];
          }
        const float logp = -0.5f * zz - ls_sum - 0.5f * (float)A * LOG_2PI;
        const float lpo = q.z, adv = q.w;  // zero-filled past the end
        const float delta = logp - lpo;
        const float ratio = expf(fminf(fmaxf(delta, -20.f), 20.f));
        const float t1 = ratio * adv;
        const float t2 = fminf(fmaxf(ratio, 1.f - g.clip_eps), 1.f + g.clip_eps) * adv;
        // min's gradient goes to t1 where t1 < t2, else to t2 (zero outside the clip)
        const bool through = (t1 < t2) || (ratio > 1.f - g.clip_eps && ratio < 1.f + g.clip_eps);
        const float dratio = through ? -adv * g.inv_rows : 0.f;
        const float dlogp = (valid && fabsf(delta) < 20.f) ? dratio * ratio : 0.f;
#pragma unroll
        for (int d = 0; d < 2; ++d) go[d] = d < A ? dlogp * (z[d] * inv_std[d]) : 0.f;
        if (adds) {
#pragma unroll
          for (int d = 0; d < 2; ++d)
            if (d < A) {
              t_b3[d] += go[d];
              t_ls[d] += dlogp * (z[d] * z[d] - 1.f);
            }
          t_pg += -fminf(t1, t2);
          t_kl += lpo - logp;
        }
      } else {
        const float v = hv[0] + b3[0];
        const float vold = q.x, tgt = q.y;
        const float eps = g.clip_eps, hd = g.huber_delta;
        const float dv_raw = v - vold;
        const float vclip = vold + fminf(fmaxf(dv_raw, -eps), eps);
        const float e1 = v - tgt, e2 = vclip - tgt;
        const float l1 = huber(e1, hd), l2 = huber(e2, hd);
        // max's gradient goes to l1 where l1 > l2, else to l2 (zero outside the clip)
        const float d1 = fminf(fmaxf(e1, -hd), hd), d2 = fminf(fmaxf(e2, -hd), hd);
        const float dv = (l1 > l2 ? d1 : (fabsf(dv_raw) < eps ? d2 : 0.f)) * g.value_coef * g.inv_rows;
        go[0] = valid ? dv : 0.f;
        if (adds) {
          t_b3[0] += go[0];
          t_pg += fmaxf(l1, l2);
        }
      }
      // every lane takes the four rows' dL/dhead from lanes tx = 0..3
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gh[i][0] = __shfl_sync(0xffffffffu, go[0], (lane & 16) + i);
        gh[i][1] = ACTOR ? __shfl_sync(0xffffffffu, go[1], (lane & 16) + i) : 0.f;
      }
    }
    {
      float gg[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          aW3[j][0] = fmaf(acc[i][j], gh[i][0], aW3[j][0]);
          if (ACTOR) aW3[j][1] = fmaf(acc[i][j], gh[i][1], aW3[j][1]);
          const float s = fmaf(gh[i][1], w3r[j][1], gh[i][0] * w3r[j][0]);
          gg[i][j] = acc[i][j] > 0.f ? s : 0.f;
          ab2[j] += gg[i][j];
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) st4(g2 + (4 * ty + i) * H + 4 * tx, gg[i][0], gg[i][1], gg[i][2], gg[i][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) st4(g2t + swz(4 * tx + j, ty), gg[0][j], gg[1][j], gg[2][j], gg[3][j]);
    }
    __syncthreads();

    // ---- 3. dW2 += h1^T g2; g1 = (g2 W2^T) * (h1 > 0), into h1t's space ----
#pragma unroll 1
    for (int q0 = 0; q0 < R; q0 += 16)
#pragma unroll
      for (int q = q0; q < q0 + 16; ++q) fma44(aW2, ld4(h1 + q * H + 4 * ty), ld4(g2 + q * H + 4 * tx));
    zero44(acc);
    mm_t(acc, g2t, w2t, ty, tx);
    float* g1 = h1t;  // h1^T was last read in phase 2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = (m1 >> (4 * i + j)) & 1u ? acc[i][j] : 0.f;
        ab1[j] += acc[i][j];
      }
      st4(g1 + (4 * ty + i) * H + 4 * tx, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();

    // ---- 4. dW1 += x^T g1, four rows a step; rows k >= K skipped (uniform
    // over a warp, whose two row groups ty share k < K: K is even).  WIDE:
    // groups of 16 KR rows, each group's sums added into the slice ----
    for (int k0 = 0; k0 < (WIDE ? K : 1); k0 += 16 * KR) {
      if (WIDE)
#pragma unroll
        for (int q = 0; q < KR; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) aW1[q][j] = 0.f;
#pragma unroll 2
      for (int r = 0; r < R; r += 4) {
        const float4 b0 = ld4(g1 + r * H + 4 * tx), b1 = ld4(g1 + (r + 1) * H + 4 * tx);
        const float4 b2 = ld4(g1 + (r + 2) * H + 4 * tx), b3v = ld4(g1 + (r + 3) * H + 4 * tx);
#pragma unroll
        for (int q = 0; q < KR; ++q) {
          const int k = k0 + ty + 16 * q;
          if (k < K) {
            const float4 a = ld4(x + k * XS + r);  // x[r..r+3][k]
            aW1[q][0] = fmaf(a.w, b3v.x, fmaf(a.z, b2.x, fmaf(a.y, b1.x, fmaf(a.x, b0.x, aW1[q][0]))));
            aW1[q][1] = fmaf(a.w, b3v.y, fmaf(a.z, b2.y, fmaf(a.y, b1.y, fmaf(a.x, b0.y, aW1[q][1]))));
            aW1[q][2] = fmaf(a.w, b3v.z, fmaf(a.z, b2.z, fmaf(a.y, b1.z, fmaf(a.x, b0.z, aW1[q][2]))));
            aW1[q][3] = fmaf(a.w, b3v.w, fmaf(a.z, b2.w, fmaf(a.y, b1.w, fmaf(a.x, b0.w, aW1[q][3]))));
          }
        }
      }
      if (WIDE) {
        float* dW1 = g.part + (size_t)blockIdx.x * slice_len(K, A, ACTOR);
        const bool first = c == (int)blockIdx.x;
#pragma unroll
        for (int q = 0; q < KR; ++q) {
          const int k = k0 + ty + 16 * q;
          if (k < K)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float* p = dW1 + k * H + 4 * tx + j;
              *p = first ? aW1[q][j] : *p + aW1[q][j];
            }
        }
      }
    }
    if (g.stages == 2) {
      buf ^= 1;
    } else if (more) {  // one stage: the next chunk's copies wait for this chunk's reads
      __syncthreads();
      stage<ACTOR>(g, walk, xs, rqs, c + g.G);
    }
  }

  // ---- the block's slice ----
  const int P = slice_len(K, A, ACTOR);
  float* part = g.part + (size_t)blockIdx.x * P;
  const int oW1 = 0, ob1 = K * H, oW2 = ob1 + H, ob2 = oW2 + H * H, oW3 = ob2 + H, ob3 = oW3 + H * A,
            otail = ob3 + A;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[oW2 + (4 * ty + i) * H + 4 * tx + j] = aW2[i][j];
  if (!WIDE) {
#pragma unroll
    for (int q = 0; q < KR; ++q) {
      const int k = ty + 16 * q;
      if (k < K)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[oW1 + k * H + 4 * tx + j] = aW1[q][j];
    }
  } else if (blockIdx.x * R >= g.rows) {  // a block without a chunk: its dW1 is 0
    for (int i = tid; i < K * H; i += NT) part[oW1 + i] = 0.f;
  }
  // column sums over the 16 row groups (ty), in order: 16 values a thread
  __syncthreads();  // every chunk's reads of h1 are done
  float* red = h1;  // [NT][16]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[tid * 16 + j] = ab1[j];
    red[tid * 16 + 4 + j] = ab2[j];
    red[tid * 16 + 8 + 2 * j] = aW3[j][0];
    red[tid * 16 + 9 + 2 * j] = aW3[j][1];
  }
  float* tails = h1 + NT * 16;  // [16][8]: row sums of the lanes tx < 4, summed
  float tv[6] = {t_b3[0], t_b3[1], t_ls[0], t_ls[1], t_pg, t_kl};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    tv[q] += __shfl_xor_sync(0xffffffffu, tv[q], 1);
    tv[q] += __shfl_xor_sync(0xffffffffu, tv[q], 2);
    if (tx == 0) tails[ty * 8 + q] = tv[q];
  }
  __syncthreads();
  {
    const int q = tid & 15, cx = tid >> 4;  // value q of column group cx
    float s = 0.f;
    for (int y = 0; y < 16; ++y) s += red[((y << 4) + cx) * 16 + q];
    if (q < 4)
      part[ob1 + 4 * cx + q] = s;
    else if (q < 8)
      part[ob2 + 4 * cx + q - 4] = s;
    else if (((q - 8) & 1) < A)
      part[oW3 + (4 * cx + ((q - 8) >> 1)) * A + ((q - 8) & 1)] = s;
  }
  if (tid < 6) {
    float s = 0.f;
    for (int y = 0; y < 16; ++y) s += tails[y * 8 + tid];
    // tail order: db3 [A], then (actor) dlog_std [A], pg, kl; (critic) v
    if (tid < 2) {
      if (tid < A) part[ob3 + tid] = s;
    } else if (ACTOR) {
      if (tid < 4) {
        if (tid - 2 < A) part[otail + tid - 2] = s;
      } else {
        part[otail + A + tid - 4] = s;
      }
    } else if (tid == 4) {
      part[otail] = s;
    }
  }
}

// out[p] = sum over blocks of part[b][p], in a fixed order: warp w of 8 sums
// the blocks b = w (mod 8) in turn, then the eight sums are added in order.
// A block takes 32 entries p.
__global__ void __launch_bounds__(256) slice_sum_kernel(const float* __restrict__ part,
                                                        float* __restrict__ out, int P, int G) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, p = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (p < P)
    for (int b = w; b < G; b += 8) s += part[(size_t)b * P + p];
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && p < P) {
    float t = red[0][lane];
#pragma unroll
    for (int v = 1; v < 8; ++v) t += red[v][lane];
    out[p] = t;
  }
}

using KernelFn = void (*)(Role);

// The kernel of a role at rows K floats wide.
template <bool ACTOR>
KernelFn kernel_for(int K) {
  if (K <= 32) return ppo_grad_kernel<ACTOR, 2, false>;
  if (K <= 64) return ppo_grad_kernel<ACTOR, 4, false>;
  if (K <= 128) return ppo_grad_kernel<ACTOR, 8, false>;
  return ppo_grad_kernel<ACTOR, 8, true>;
}

// Resident blocks an SM of the role's kernel at rows K floats wide, and its
// stages: two, unless one stage fits more blocks (0 blocks: the rows do not
// fit the card's shared memory; -1: a CUDA error).
template <bool ACTOR>
int plan(int K, int* stages) {
  const KernelFn fn = kernel_for<ACTOR>(K);
  int dev = 0, optin = 0, best = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  *stages = 2;
  for (int st = 2; st >= 1; --st) {
    const int smem = smem_floats(K, st) * (int)sizeof(float);
    int n = 0;
    if (smem > optin) continue;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NT, smem) != cudaSuccess)
      return -1;
    if (n > best) {
      best = n;
      *stages = st;
    }
  }
  return best;
}

template <bool ACTOR>
cudaError_t launch_role(const Role& g, cudaStream_t s) {
  const KernelFn fn = kernel_for<ACTOR>(g.K);
  const int smem = smem_floats(g.K, g.stages) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<g.G, NT, smem, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = slice_len(g.K, ACTOR ? g.A : 1, ACTOR);
  slice_sum_kernel<<<(P + 31) / 32, 256, 0, s>>>(g.part, g.part + (size_t)g.G * P, P, g.G);
  return cudaGetLastError();
}

}  // namespace

// The launch plan of one role (actor != 0: the actor's) at rows K floats
// wide: returns the resident blocks an SM (0 where the rows do not fit, -1 on
// a CUDA error) and writes the stages of the input copies to *stages.
extern "C" int fused_ppo_grad_plan(int K, int actor, int* stages) {
  if (K < 1) return 0;
  return actor ? plan<true>(K, stages) : plan<false>(K, stages);
}

// part_a [Ga + 1][Pa] and part_c [Gc + 1][Pc]: the blocks' slices, then the
// sum over them (the last row).
extern "C" int fused_ppo_grad_launch(
    const void* obs, const void* act, const void* lpo, const void* adv, const void* vold,
    const void* tgt, const void* aw1, const void* ab1, const void* aw2, const void* ab2,
    const void* aw3, const void* ab3, const void* als, const void* cw1, const void* cb1,
    const void* cw2, const void* cb2, const void* cw3, const void* cb3, void* part_a,
    void* part_c, int Ma, int M, int DO, int DC, int A, int Ga, int Gc, int Sa, int Sc,
    float clip_eps, float huber_delta, float value_coef, float inv_ma, float inv_mc,
    void* stream) {
  if (A < 1 || A > 2 || Ga < 1 || Gc < 1 || DO < 1 || DC < 1 || Sa < 1 || Sa > 2 || Sc < 1 || Sc > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Role ga = {(const float*)obs, (const float*)act, (const float*)lpo, (const float*)adv,
                   (const float*)aw1, (const float*)ab1, (const float*)aw2, (const float*)ab2,
                   (const float*)aw3, (const float*)ab3, (const float*)als, (float*)part_a,
                   Ma, DO, A, Ga, Sa, clip_eps, huber_delta, value_coef, inv_ma};
  const Role gc = {(const float*)obs, nullptr, (const float*)vold, (const float*)tgt,
                   (const float*)cw1, (const float*)cb1, (const float*)cw2, (const float*)cb2,
                   (const float*)cw3, (const float*)cb3, nullptr, (float*)part_c,
                   M, DC, 1, Gc, Sc, clip_eps, huber_delta, value_coef, inv_mc};
  cudaError_t err = launch_role<true>(ga, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_role<false>(gc, s);
}
