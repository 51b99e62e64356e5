// step_reset: the fused rollout's state glue and auto-reset of one step.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the glue of the JAX
// package's fused rollout (gym_formation_tpu/env.py:rollout_statepolicy_fused)
// into the step's program; in PyTorch the same glue was some 40 small
// launches a step.  Same function as the plain version
// gym_formation_tpu_torch/ops/kernels/step_reset.py:step_reset_plain.
// For env b of the B rows, with n agents and n landmarks, K3's new agents
// (npos, nvel), and row r = row0 + b of the auto-reset's raw U(0, 1) draws
// (ua, ul [Bg, n, 2], uv [Bg, 2]; Bg the global batch under a mesh):
//
//   t1       = t + 1,  done = t1 >= world_length
//   velterm  = -|ivel - mean_i nvel_i|          (the episode's own ivel)
//   not done: agents (npos, nvel), landmarks l + (mean(npos) - mean(l)),
//             their velocities carried, shape and ivel carried, t = t1
//   done:     agents a = 2 ua_r - 1 at rest, landmarks f = 2 ul_r - 1 as
//             f + (mean(a) - mean(f)) at rest, shape f - mean(f),
//             ivel 2 uv_r - 1, t = 0
//
// (FormationHDScenario.reset, then pre_obs, which recentres the landmarks
// onto the agents' centroid.)  The communication state, zero in the fused
// rollout, is not touched.
//
// What bounds it on the H100: device memory.  A row that carries on reads
// 10 n floats (npos, nvel, the landmarks and their velocities, the shape)
// and writes 10 n; a row that resets reads 6 n (nvel and the two draws) and
// writes as many: about 19 KB an env at n = 243, 0.16 GB a step at B = 8192,
// 0.05 ms at 3.35 TB/s.  The arithmetic is a few operations a float.
//
// Design: a group of G lanes of one warp per env (G the smallest power of
// two >= n, at most 32), 256 / G envs a block; lane l takes agents l, l + G,
// ..., so a warp's loads and stores of one field are consecutive float2s
// (8 bytes, an agent's two coordinates; 16 bytes would want n even for the
// landmarks' alignment).  A lane issues the loads of K = 4 agents before it
// uses any: on the H100 at n = 243, B = 8192, no row resetting, one agent a
// pass took 0.102 ms, two 0.074, four 0.065, eight 0.064 but 0.081 where
// every row resets (145 registers).  A row reads the draws only where it
// resets, and the old landmarks, velocities and shape only where it does
// not.  The six sums (agents, landmarks, velocities) are reduced by xor
// shuffles within the group, which leave the same bits in every lane, so
// there is no barrier.  The landmarks wait for the two centroids in shared
// memory, n float2 an env; each lane reads back only what it wrote.  Every
// sum goes in an order fixed by n and G, so two launches give the same bits;
// the centroids differ from PyTorch's mean by the order of the sums alone.
// u * 2 - 1 rounds twice, as the plain version's two operations do, so the
// fresh agents, landmarks before their shift, and ivel match it bit for bit.

#include "common.cuh"

namespace {

constexpr int SR_THREADS = 256;
constexpr int K = 4;  // agents a lane takes in one pass of its loop

// U(0, 1) -> U(-1, 1), as the scenario's u * 2 - 1 (two roundings, no FMA)
__device__ __forceinline__ float2 pm1(float2 u) {
  return make_float2(rn_sub(rn_mul(u.x, 2.f), 1.f), rn_sub(rn_mul(u.y, 2.f), 1.f));
}

// Sum over the G lanes of a group (G a power of two dividing 32); every lane
// gets the same bits.
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, G);
  return v;
}

__global__ void __launch_bounds__(SR_THREADS)
    step_reset_kernel(const float2* __restrict__ pos, const float2* __restrict__ vel,
                      const float2* __restrict__ ishape, const float2* __restrict__ ivel,
                      const int* __restrict__ t, const float2* __restrict__ npos,
                      const float2* __restrict__ nvel, const float2* __restrict__ ua,
                      const float2* __restrict__ ul, const float2* __restrict__ uv,
                      float2* __restrict__ opos, float2* __restrict__ ovel,
                      float2* __restrict__ oishape, float2* __restrict__ oivel, int* __restrict__ ot,
                      float* __restrict__ velterm, unsigned char* __restrict__ done, int B, int n,
                      int G, int row0, int world_length) {
  extern __shared__ float2 keep_all[];  // the landmarks of the block's envs, n each
  const int slot = threadIdx.x / G, lane = threadIdx.x % G;
  const int b = blockIdx.x * (blockDim.x / G) + slot;
  const bool live = b < B;  // a group past B still joins its warp's shuffles
  const int t1 = live ? t[b] + 1 : 0;
  const bool d = live && t1 >= world_length;
  const size_t e0 = (size_t)b * 2 * n;       // env b's first entity
  const size_t a0 = (size_t)b * n;           // its first agent
  const size_t r0 = (size_t)(row0 + b) * n;  // its row of the draws
  float2* keep = keep_all + (size_t)slot * n;
  const float2 zero = make_float2(0.f, 0.f);
  float ax = 0.f, ay = 0.f, lx = 0.f, ly = 0.f, vx = 0.f, vy = 0.f;
  const int m = live ? n : 0;
  // K agents a lane a pass, all their loads issued before any is used
  for (int i0 = lane; i0 < m; i0 += K * G) {
    float2 v[K], a[K], l[K], lv[K], sh[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k * G;
      if (i >= m) continue;
      v[k] = nvel[a0 + i];
      if (d) {
        a[k] = pm1(ua[r0 + i]);
        l[k] = pm1(ul[r0 + i]);
      } else {
        a[k] = npos[a0 + i];
        l[k] = pos[e0 + n + i];
        lv[k] = vel[e0 + n + i];
        sh[k] = ishape[a0 + i];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k * G;
      if (i >= m) continue;
      vx += v[k].x;
      vy += v[k].y;
      if (d) {
        ovel[e0 + i] = zero;
        ovel[e0 + n + i] = zero;
      } else {
        ovel[e0 + i] = v[k];
        ovel[e0 + n + i] = lv[k];
        oishape[a0 + i] = sh[k];
      }
      opos[e0 + i] = a[k];
      ax += a[k].x;
      ay += a[k].y;
      lx += l[k].x;
      ly += l[k].y;
      keep[i] = l[k];
    }
  }
  ax = group_sum(ax, G);
  ay = group_sum(ay, G);
  lx = group_sum(lx, G);
  ly = group_sum(ly, G);
  vx = group_sum(vx, G);
  vy = group_sum(vy, G);
  const float fn = (float)n;
  const float mlx = lx / fn, mly = ly / fn;
  const float dx = ax / fn - mlx, dy = ay / fn - mly;
  for (int i = lane; i < m; i += G) {
    const float2 l = keep[i];
    opos[e0 + n + i] = make_float2(l.x + dx, l.y + dy);
    if (d) oishape[a0 + i] = make_float2(l.x - mlx, l.y - mly);
  }
  if (live && lane == 0) {
    const float2 iv = ivel[b];
    const float ux = rn_sub(iv.x, vx / fn), uy = rn_sub(iv.y, vy / fn);
    velterm[b] = -sqrtf(rn_add(rn_mul(ux, ux), rn_mul(uy, uy)));
    oivel[b] = d ? pm1(uv[row0 + b]) : iv;
    ot[b] = d ? 0 : t1;
    done[b] = d;
  }
}

}  // namespace

// G, the lanes an env, and envs, the envs a block, are the wrapper's choice
// (ops/kernels/step_reset.py: launch_plan); G * envs is a multiple of 32, at
// most 256.
extern "C" int step_reset_launch(const void* pos, const void* vel, const void* ishape,
                                 const void* ivel, const void* t, const void* npos,
                                 const void* nvel, const void* ua, const void* ul, const void* uv,
                                 void* opos, void* ovel, void* oishape, void* oivel, void* ot,
                                 void* velterm, void* done, int B, int n, int G, int envs, int row0,
                                 int world_length, void* stream) {
  if (B == 0 || n == 0) return 0;
  if (G < 1 || G > 32 || (G & (G - 1)) != 0 || envs < 1 || G * envs > SR_THREADS ||
      (G * envs) % 32 != 0)  // whole warps: the shuffles take every lane
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)envs * n * sizeof(float2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_reset_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + envs - 1) / envs;
  step_reset_kernel<<<grid, G * envs, smem, (cudaStream_t)stream>>>(
      (const float2*)pos, (const float2*)vel, (const float2*)ishape, (const float2*)ivel,
      (const int*)t, (const float2*)npos, (const float2*)nvel, (const float2*)ua,
      (const float2*)ul, (const float2*)uv, (float2*)opos, (float2*)ovel, (float2*)oishape,
      (float2*)oivel, (int*)ot, (float*)velterm, (unsigned char*)done, B, n, G, row0,
      world_length);
  return (int)cudaGetLastError();
}
