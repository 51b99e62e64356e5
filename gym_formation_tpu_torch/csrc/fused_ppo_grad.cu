// K9: one PPO epoch's full actor + critic gradient, forward and hand-derived
// backward, in two kernels.
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
// critic rows of 54) an epoch is about 4.4 G actor and 2.3 G critic
// multiply-adds, forward and backward; the data read is 40 MB.  Tensor cores
// are not used (the products are f32, held against f32 plain versions).
//
// Design: kernel 1 gives each block one role, actor or critic, and a fixed,
// strided set of 64-row chunks.  A block keeps the role's weights in shared
// memory (the 64x64 layer with a row stride of 65, so that both W and its
// transpose are read without bank conflicts) and, per chunk, the input rows
// and two 64x64 activation buffers: h1 and h2 forward, then g2 over h2 and g1
// over h1 in place, in the order that keeps every operand alive.  The three
// 64-deep products of a chunk (and the two weight-gradient products over the
// chunk's rows) are register-tiled, 4x4 outputs a thread.  Each thread owns
// fixed entries of the block's gradient slice in a [blocks, P] buffer and adds
// its chunk sums there; per-row scalars (heads, loss terms) are taken by one
// thread a row and summed over the chunk in order by their owner.  Kernel 2
// sums the slices over the blocks in a fixed order.  No atomics: the result
// does not depend on scheduling, and two runs agree bit for bit.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int H = 64;    // hidden width
constexpr int R = 64;    // rows per chunk
constexpr int NT = 256;  // threads per block: a 16 x 16 grid of 4x4 tiles
constexpr int W2S = H + 1;
constexpr int ROWQ = 8;  // per-row scalars kept for the chunk sums
constexpr float LOG_2PI = 1.8378770664093453f;

struct Args {
  const float *obs, *act, *lpo, *adv, *vold, *tgt;
  const float *aw1, *ab1, *aw2, *ab2, *aw3, *ab3, *als;
  const float *cw1, *cb1, *cw2, *cb2, *cw3, *cb3;
  float *part_a, *part_c;
  int Ma, M, DO, DC, A, Ga, Gc;
  float clip_eps, huber_delta, value_coef, inv_ma, inv_mc;
};

__host__ __device__ inline int smem_floats(int K, int A) {
  return K * H + H + H * W2S + H + H * A + A + 4 + R * K + 2 * R * H + R * 4 + R * ROWQ;
}

// Layout of a block's gradient slice: dW1 [K][H], db1, dW2 [H][H], db2,
// dW3 [H][A], db3 [A], then (actor) dlog_std [A], pg sum, kl sum or
// (critic) the value-loss sum.
__host__ __device__ inline int slice_len(int K, int A, bool actor) {
  return K * H + H + H * H + H + H * A + A + (actor ? A + 2 : 1);
}

__device__ __forceinline__ float huber(float e, float delta) {
  const float a = fabsf(e);
  return a <= delta ? 0.5f * e * e : delta * (a - 0.5f * delta);
}

template <bool ACTOR>
__device__ void run_block(const Args& g, float* sm, int blk) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int K = ACTOR ? g.DO : g.DC;
  const int A = ACTOR ? g.A : 1;
  const int rows = ACTOR ? g.Ma : g.M;
  const int G = ACTOR ? g.Ga : g.Gc;
  const float* gw1 = ACTOR ? g.aw1 : g.cw1;
  const float* gb1 = ACTOR ? g.ab1 : g.cb1;
  const float* gw2 = ACTOR ? g.aw2 : g.cw2;
  const float* gb2 = ACTOR ? g.ab2 : g.cb2;
  const float* gw3 = ACTOR ? g.aw3 : g.cw3;
  const float* gb3 = ACTOR ? g.ab3 : g.cb3;
  const int P = slice_len(K, A, ACTOR);
  float* part = (ACTOR ? g.part_a : g.part_c) + (size_t)blk * P;
  const int oW1 = 0, ob1 = K * H, oW2 = ob1 + H, ob2 = oW2 + H * H, oW3 = ob2 + H,
            ob3 = oW3 + H * A, otail = ob3 + A;

  float* w1 = sm;           // [K][H]
  float* b1 = w1 + K * H;
  float* w2 = b1 + H;       // [H][W2S]
  float* b2 = w2 + H * W2S;
  float* w3 = b2 + H;       // [H][A]
  float* b3 = w3 + H * A;   // [A]
  float* ls = b3 + A;       // [4] bounded log-std (actor)
  float* x = ls + 4;        // [R][K]
  float* bufA = x + R * K;  // [R][H]: h1, then g1
  float* bufB = bufA + R * H;  // [R][H]: h2, then g2
  float* gh = bufB + R * H;    // [R][4]: dL/dmu (actor) or dL/dv (critic)
  float* rowq = gh + R * 4;    // [R][ROWQ]

  for (int p = tid; p < P; p += NT) part[p] = 0.f;
  for (int i = tid; i < K * H; i += NT) w1[i] = gw1[i];
  for (int i = tid; i < H * H; i += NT) w2[(i / H) * W2S + i % H] = gw2[i];
  for (int i = tid; i < H; i += NT) {
    b1[i] = gb1[i];
    b2[i] = gb2[i];
  }
  for (int i = tid; i < H * A; i += NT) w3[i] = gw3[i];
  if (tid < A) {
    b3[tid] = gb3[tid];
    if (ACTOR) ls[tid] = g.als[tid];
  }
  __syncthreads();

  for (int chunk = blk; chunk * R < rows; chunk += G) {
    const int r0 = chunk * R;
    for (int i = tid; i < R * K; i += NT)
      x[i] = (r0 + i / K < rows) ? g.obs[(size_t)r0 * K + i] : 0.f;
    __syncthreads();

    float acc[4][4];
    // ---- h1 = relu(x W1 + b1) ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = x[(ty + 16 * i) * K + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = w1[k * H + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bufA[(ty + 16 * i) * H + c] = fmaxf(acc[i][j] + b1[c], 0.f);
      }
    __syncthreads();

    // ---- h2 = relu(h1 W2 + b2) ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < H; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = bufA[(ty + 16 * i) * H + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = w2[k * W2S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        bufB[(ty + 16 * i) * H + c] = fmaxf(acc[i][j] + b2[c], 0.f);
      }
    __syncthreads();

    // ---- heads and the loss's per-row terms: one thread a row ----
    if (tid < R) {
      const int r = tid, row = r0 + r;
      const bool valid = row < rows;
      const float* h2 = bufB + r * H;
      if (ACTOR) {
        float z[2], inv_std[2], zz = 0.f, ls_sum = 0.f;
        for (int d = 0; d < A; ++d) {
          float mu = 0.f;
          for (int k = 0; k < H; ++k) mu = fmaf(h2[k], w3[k * A + d], mu);
          mu += b3[d];
          inv_std[d] = expf(-ls[d]);
          z[d] = valid ? (g.act[(size_t)row * A + d] - mu) * inv_std[d] : 0.f;
          zz += z[d] * z[d];
          ls_sum += ls[d];
        }
        const float logp = -0.5f * zz - ls_sum - 0.5f * (float)A * LOG_2PI;
        const float lpo = valid ? g.lpo[row] : 0.f, adv = valid ? g.adv[row] : 0.f;
        const float delta = logp - lpo;
        const float ratio = expf(fminf(fmaxf(delta, -20.f), 20.f));
        const float t1 = ratio * adv;
        const float t2 = fminf(fmaxf(ratio, 1.f - g.clip_eps), 1.f + g.clip_eps) * adv;
        // min's gradient goes to t1 where t1 < t2, else to t2 (zero outside the clip)
        const bool through = (t1 < t2) || (ratio > 1.f - g.clip_eps && ratio < 1.f + g.clip_eps);
        const float dratio = through ? -adv * g.inv_ma : 0.f;
        const float dlogp = (valid && fabsf(delta) < 20.f) ? dratio * ratio : 0.f;
        for (int d = 0; d < A; ++d) {
          gh[r * 4 + d] = dlogp * (z[d] * inv_std[d]);
          rowq[r * ROWQ + d] = dlogp * (z[d] * z[d] - 1.f);
        }
        rowq[r * ROWQ + 4] = valid ? -fminf(t1, t2) : 0.f;
        rowq[r * ROWQ + 5] = valid ? lpo - logp : 0.f;
      } else {
        float v = 0.f;
        for (int k = 0; k < H; ++k) v = fmaf(h2[k], w3[k], v);
        v += b3[0];
        const float vold = valid ? g.vold[row] : 0.f, tgt = valid ? g.tgt[row] : 0.f;
        const float eps = g.clip_eps, hd = g.huber_delta;
        const float dv_raw = v - vold;
        const float vclip = vold + fminf(fmaxf(dv_raw, -eps), eps);
        const float e1 = v - tgt, e2 = vclip - tgt;
        const float l1 = huber(e1, hd), l2 = huber(e2, hd);
        // max's gradient goes to l1 where l1 > l2, else to l2 (zero outside the clip)
        const float d1 = fminf(fmaxf(e1, -hd), hd), d2 = fminf(fmaxf(e2, -hd), hd);
        const float dv = (l1 > l2 ? d1 : (fabsf(dv_raw) < eps ? d2 : 0.f)) * g.value_coef * g.inv_mc;
        gh[r * 4] = valid ? dv : 0.f;
        rowq[r * ROWQ] = valid ? fmaxf(l1, l2) : 0.f;
      }
    }
    __syncthreads();

    // ---- head gradients and the chunk's sums, each by its owner ----
    if (tid < H * A) {
      const int k = tid / A, d = tid % A;
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = fmaf(bufB[r * H + k], gh[r * 4 + d], s);
      part[oW3 + k * A + d] += s;
    } else if (tid < H * A + A) {
      const int d = tid - H * A;
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += gh[r * 4 + d];
      part[ob3 + d] += s;
    } else if (tid < H * A + A + (ACTOR ? A + 2 : 1)) {
      const int q = tid - H * A - A;  // actor: dlog_std[0..A), pg, kl; critic: v
      const int col = ACTOR ? (q < A ? q : 4 + (q - A)) : 0;
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += rowq[r * ROWQ + col];
      part[otail + q] += s;
    }
    __syncthreads();

    // ---- g2 = (dL/dhead W3^T) * (h2 > 0), in place over h2 ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float s = 0.f;
        for (int d = 0; d < A; ++d) s = fmaf(gh[r * 4 + d], w3[c * A + d], s);
        bufB[r * H + c] = bufB[r * H + c] > 0.f ? s : 0.f;
      }
    __syncthreads();

    // ---- dW2 += h1^T g2, db2 += sum g2 ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r = 0; r < R; ++r) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = bufA[r * H + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bufB[r * H + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[oW2 + (ty + 16 * i) * H + tx + 16 * j] += acc[i][j];
    if (tid < H) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += bufB[r * H + tid];
      part[ob2 + tid] += s;
    }
    __syncthreads();

    // ---- g1 = (g2 W2^T) * (h1 > 0), in place over h1 ----
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < H; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = bufB[(ty + 16 * i) * H + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = w2[(tx + 16 * j) * W2S + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = (ty + 16 * i) * H + tx + 16 * j;
        bufA[idx] = bufA[idx] > 0.f ? acc[i][j] : 0.f;
      }
    __syncthreads();

    // ---- dW1 += x^T g1, db1 += sum g1 ----
    for (int kt = 0; kt < K; kt += 64) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int r = 0; r < R; ++r) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = kt + ty + 16 * i;
          av[i] = k < K ? x[r * K + k] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bufA[r * H + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kt + ty + 16 * i;
        if (k < K)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[oW1 + k * H + tx + 16 * j] += acc[i][j];
      }
    }
    if (tid < H) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += bufA[r * H + tid];
      part[ob1 + tid] += s;
    }
    __syncthreads();  // x, bufA, bufB are refilled by the next chunk
  }
}

__global__ void __launch_bounds__(NT) ppo_grad_kernel(Args g) {
  extern __shared__ float sm[];
  if ((int)blockIdx.x < g.Ga)
    run_block<true>(g, sm, blockIdx.x);
  else
    run_block<false>(g, sm, blockIdx.x - g.Ga);
}

// out[p] = sum over blocks b = 0, 1, ... of part[b][p], in that order
__global__ void slice_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int P,
                                 int G) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int b = 0; b < G; ++b) s += part[(size_t)b * P + p];
  out[p] = s;
}

}  // namespace

extern "C" int fused_ppo_grad_smem_bytes(int DO, int DC, int A) {
  const int a = smem_floats(DO, A), c = smem_floats(DC, 1);
  return (a > c ? a : c) * (int)sizeof(float);
}

extern "C" int fused_ppo_grad_launch(
    const void* obs, const void* act, const void* lpo, const void* adv, const void* vold,
    const void* tgt, const void* aw1, const void* ab1, const void* aw2, const void* ab2,
    const void* aw3, const void* ab3, const void* als, const void* cw1, const void* cb1,
    const void* cw2, const void* cb2, const void* cw3, const void* cb3, void* part_a,
    void* part_c, void* out_a, void* out_c, int Ma, int M, int DO, int DC, int A, int Ga,
    int Gc, float clip_eps, float huber_delta, float value_coef, float inv_ma, float inv_mc,
    void* stream) {
  if (A < 1 || A > 2 || Ga < 1 || Gc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = fused_ppo_grad_smem_bytes(DO, DC, A);
  cudaError_t err =
      cudaFuncSetAttribute(ppo_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Args g = {(const float*)obs, (const float*)act, (const float*)lpo, (const float*)adv,
            (const float*)vold, (const float*)tgt, (const float*)aw1, (const float*)ab1,
            (const float*)aw2, (const float*)ab2, (const float*)aw3, (const float*)ab3,
            (const float*)als, (const float*)cw1, (const float*)cb1, (const float*)cw2,
            (const float*)cb2, (const float*)cw3, (const float*)cb3, (float*)part_a,
            (float*)part_c, Ma, M, DO, DC, A, Ga, Gc, clip_eps, huber_delta, value_coef,
            inv_ma, inv_mc};
  ppo_grad_kernel<<<Ga + Gc, NT, smem, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int Pa = slice_len(DO, A, true), Pc = slice_len(DC, 1, false);
  slice_sum_kernel<<<(Pa + 255) / 256, 256, 0, s>>>((const float*)part_a, (float*)out_a, Pa, Ga);
  slice_sum_kernel<<<(Pc + 255) / 256, 256, 0, s>>>((const float*)part_c, (float*)out_c, Pc, Gc);
  return (int)cudaGetLastError();
}
