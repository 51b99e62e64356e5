// K8: soft-contact pair forces with far pairs culled exactly, by a per-env
// grid of cells built inside the kernel.
//
// Replaces gym_formation_tpu/ops/pallas/pairforce_cull.py:collision_forces_culled
// (its _kernel).  Same function as the plain version
// gym_formation_tpu_torch/ops/kernels/pairforce_cull.py:collision_forces_culled_plain,
// which equals K6's up to the order of each receiver's sum:
//
//   d      = |p_i - p_j|
//   pen    = k * softplus(-(d - (s_i + s_j)) / k)
//   F_i    = sum_j w_ij * cf * pen / max(d, 1e-12) * (p_i - p_j)
//   w_ij   = collide_i collide_j movable_i (movable_j ? m_j / m_i : 1)
//
// What bounds it on the H100: latency, in two halves of about the same
// size at the cull selector path's state (N=243, a box about 2.1 wide,
// 1.95% of the ordered pairs within the cutoff).  The set-up of the grid is
// a chain of short phases between block barriers (loads, the box, the
// histogram, the scan, one warp's placement, the gather).  The pair loop
// takes 36 SASS instructions a candidate (contact_coef's rsqrt, ex2 and
// lg2; two shared float4 loads; K6's weight); a receiver meets about 14
// candidates, 3 times the pairs within the cutoff (3 x 3 cells at least a
// cutoff wide around a disc of it), and the lanes of a warp loop over
// different counts.  Device memory traffic is B x E x (8 + 8) bytes and
// the 4 x E entity table.
//
// Design: one thread block per env does everything; the wrapper allocates
// the output and launches.  The TPU kernel sorts by a Morton key outside its
// body and culls tile pairs of 8, because its lanes are envs; here a block
// holds one env and bins it itself.
//   1. The box of the env's colliding entities (block min and max; fminf
//      and fmaxf leave a NaN coordinate out).
//   2. A grid of gx x gy cells over it, g = floor(extent / width) an axis
//      with width = cutoff (1 + 2^-10) (the wrapper's _cell_width), clamped
//      into [1, MAX_AXIS_CELLS]; while gx gy > 2 Ep the axis with more cells
//      halves its count (rounding up), which only widens the cells.  An
//      entity's column is (x - lo) * (gx / extent), clamped into [0, gx - 1]
//      (a NaN to 0, an infinity to an edge) and truncated; its row likewise.
//      Every index lands in the table, whatever the coordinates.  A
//      non-colliding entity takes no cell and gets force 0.
//   3. A counting sort by cell in shared memory: a histogram (shared
//      atomics: integer counts, exact in any order), an inclusive scan, then
//      one warp places the entities from the last to the first, 32 at a
//      time, __match_any_sync grouping the lanes of one cell: each cell
//      keeps its entities in index order, so the sorted order depends on the
//      positions alone.  Placing an entity at --end[c] turns each cell's end
//      into its start.  Then every thread gathers P and Q (K6's two float4s,
//      contact_entity) into sorted order.
//   4. One thread a sorted slot: a movable colliding receiver visits the
//      three rows of cells around its own, each row's three cells one
//      contiguous range of the sorted entities, and sums contact_coef with
//      K6's weight (contact_weight) over every candidate j != i.  Each pair
//      is evaluated from both sides: no atomics.  Receivers in cell order
//      keep the lanes of a warp near each other in space, so their loops
//      have similar lengths.  The force goes to the entity's own index.
//
// Exactness of the cull.  With one cell on an axis no two columns differ.
// Otherwise let h = 1/s, s = rn(g / rn(hi - lo)), be the cells' width as
// computed: g <= rn(extent / width) gives h >= width (1 - 2^-23), and the
// float32 width the launcher gets is at least cutoff (1 + 2^-10)
// (1 - 2^-24).  The computed index of x is the floor of u = rn(rn(x - lo)
// s) = (x - lo) s (1 + e), |e| <= 2^-23 + 2^-48, and u <= g (1 + 2^-22).
// If the columns of x_i and x_j differ by 2 or more (clamping and
// truncation are monotone, so the unclamped floors do too), u_i - u_j > 1,
// so (x_i - x_j) s > 1 - (u_i + u_j) |e| >= 1 - 2^-21 g >= 1 - 2^-11 (g <=
// MAX_AXIS_CELLS = 2^10), and x_i - x_j > h (1 - 2^-11) >= cutoff
// (1 + 2^-10) (1 - 2^-22) (1 - 2^-11) > cutoff.  So a pair in
// non-neighbouring cells is farther apart than cutoff = 2 max(collide size)
// + 104 k on one axis, and its depth w = s_i + s_j - d < -104 k:
// contact_coef's ex2.approx.ftz of -|w| log2(e) / k < -150 is 0 (it is 0
// below -126 already, room for the rounding of d and of the sizes),
// lg2.approx(1) is 0 and max(w, 0) is 0, so the pair would have added
// exactly 0.  No --use_fast_math is needed for that, and none is used.  The
// cull changes no bit of the result; only the order of each receiver's sum
// differs from the plain version's.
//
// Determinism: the grid, the sorted order and every receiver's candidate
// order follow from the positions alone, so two launches give the same
// bits.  pairs[b], when given, gains the env's count of evaluated ordered
// pairs (an integer sum, exact in any order).

#include "common.cuh"

#define MAX_AXIS_CELLS 1024

// 12 words an entity padded to 32 (P and Q, slot -> entity, entity -> cell,
// the cell table of 2 Ep + 1 words) and 128 words of scratch
__host__ __device__ inline size_t pairforce_cull_smem_bytes(int E) {
  const size_t Ep = (size_t)32 * ((E + 31) / 32);
  return (12 * Ep + 1 + 128) * sizeof(float);
}

// Cells on one axis of extent w (NaN or below one width: 1)
__device__ __forceinline__ int axis_cells(float w, float width) {
  const float g = floorf(rn_div(w, width));
  return g >= 1.f ? (int)fminf(g, (float)MAX_AXIS_CELLS) : 1;
}

// The cell index of coordinate v on an axis of g cells from lo, s = g / w
__device__ __forceinline__ int axis_index(float v, float lo, float s, int g) {
  const float u = rn_mul(rn_sub(v, lo), s);
  return (int)fminf(fmaxf(u, 0.f), (float)(g - 1));  // fmaxf(NaN, 0) is 0
}

// At most 32 registers (2 blocks of 1024 threads, or 8 of 256, an SM): the
// set-up is a chain of barriers and short phases, so more blocks in flight
// hide more of its latency, worth the few spilled words.
__global__ void __launch_bounds__(1024, 2)
pairforce_cull_kernel(const float* __restrict__ pos, const float* __restrict__ ent,
                      float* __restrict__ force, int* __restrict__ pairs, int E, float k,
                      float cf, float width) {
  extern __shared__ float4 sh4[];
  const int Ep = ((E + 31) >> 5) << 5, cap = 2 * Ep;
  float4* P = sh4;  // colliding entities in cell order
  float4* Q = sh4 + Ep;
  int* orig = (int*)(sh4 + 2 * Ep);  // sorted slot -> entity
  int* cell_of = orig + Ep;          // entity -> its cell, -1 if it does not collide
  int* start = cell_of + Ep;         // cap + 1: counts, ends, then starts of the cells
  float* red = (float*)(start + cap + 1);  // 128 words of scratch
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const float* p_in = pos + (size_t)blockIdx.x * E * 2;
  float* f_out = force + (size_t)blockIdx.x * E * 2;

  // 1. the box of the colliding entities
  float lox = INFINITY, hix = -INFINITY, loy = INFINITY, hiy = -INFINITY;
  for (int e = tid; e < E; e += nt) {
    if (ent[3 * E + e] != 0.f) {
      const float x = p_in[2 * e], y = p_in[2 * e + 1];
      lox = fminf(lox, x);
      hix = fmaxf(hix, x);
      loy = fminf(loy, y);
      hiy = fmaxf(hiy, y);
    }
  }
  lox = warp_min(lox);
  hix = warp_max(hix);
  loy = warp_min(loy);
  hiy = warp_max(hiy);
  if (lane == 0) {
    red[warp] = lox;
    red[32 + warp] = hix;
    red[64 + warp] = loy;
    red[96 + warp] = hiy;
  }
  for (int c = tid; c <= cap; c += nt) start[c] = 0;
  __syncthreads();
  if (warp == 0) {
    const bool w = lane < nwarps;
    const float a = warp_min(w ? red[lane] : INFINITY);
    const float b = warp_max(w ? red[32 + lane] : -INFINITY);
    const float c = warp_min(w ? red[64 + lane] : INFINITY);
    const float d = warp_max(w ? red[96 + lane] : -INFINITY);
    if (lane == 0) {
      red[0] = a;
      red[32] = b;
      red[64] = c;
      red[96] = d;
    }
  }
  __syncthreads();

  // 2. the grid: every thread computes the same from the same box
  lox = red[0];
  loy = red[64];
  const float wx = rn_sub(red[32], lox), wy = rn_sub(red[96], loy);
  int gx = axis_cells(wx, width), gy = axis_cells(wy, width);
  while (gx * gy > cap) {
    if (gx >= gy)
      gx = (gx + 1) >> 1;
    else
      gy = (gy + 1) >> 1;
  }
  const float sx = rn_div((float)gx, wx), sy = rn_div((float)gy, wy);
  const int ncell = gx * gy;

  // 3. the counting sort by cell
  for (int e = tid; e < E; e += nt) {
    int c = -1;
    if (ent[3 * E + e] != 0.f) {
      c = axis_index(p_in[2 * e + 1], loy, sy, gy) * gx + axis_index(p_in[2 * e], lox, sx, gx);
      atomicAdd(&start[c], 1);
    } else {
      f_out[2 * e] = f_out[2 * e + 1] = 0.f;
    }
    cell_of[e] = c;
  }
  block_scan_incl(start, ncell + 1, (int*)red);  // start[c]: the end of cell c
  if (warp == 0) {
    for (int base = (E - 1) & ~31; base >= 0; base -= 32) {
      const int e = base + lane;
      const int c = e < E ? cell_of[e] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, c);
      if (c >= 0) {
        const int top = 31 - __clz(peers);           // the group's highest lane
        const int above = __popc(peers >> lane) - 1;  // its members above this lane
        int end = 0;
        if (lane == top) {
          end = start[c];
          start[c] = end - __popc(peers);
        }
        end = __shfl_sync(peers, end, top);
        orig[end - 1 - above] = e;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const int n = start[ncell];  // colliding entities
  for (int t = tid; t < n; t += nt) {
    const int e = orig[t];
    contact_entity(ent, E, e, p_in[2 * e], p_in[2 * e + 1], P[t], Q[t]);
  }
  if (tid == 0) *(int*)red = 0;
  __syncthreads();

  // 4. the pairs of neighbouring cells, one receiver a thread
  const float c_exp = 1.44269504f / k, c_log = k * 0.693147181f;
  int count = 0;
  for (int t = tid; t < n; t += nt) {
    const float4 pa = P[t], qa = Q[t];
    const int e = orig[t];
    float fx = 0.f, fy = 0.f;
    if (qa.z != 0.f) {  // movable and colliding
      const int c = cell_of[e], cx = c % gx, cy = c / gx;
      const int x0 = max(cx - 1, 0), x1 = min(cx + 1, gx - 1);
      for (int ry = max(cy - 1, 0); ry <= min(cy + 1, gy - 1); ++ry) {
        const int j0 = start[ry * gx + x0], j1 = start[ry * gx + x1 + 1];
        count += j1 - j0;
#pragma unroll 2
        for (int j = j0; j < j1; ++j) {
          if (j == t) continue;
          const float4 pb = P[j], qb = Q[j];
          const float dx = pa.x - pb.x, dy = pa.y - pb.y;
          const float g = contact_coef(dx, dy, pa.z + pb.z, c_exp, c_log, cf);
          const float w = contact_weight(pa, qa, qb);
          fx += w * (g * dx);
          fy += w * (g * dy);
        }
      }
      --count;  // the receiver itself
    }
    f_out[2 * e] = fx;
    f_out[2 * e + 1] = fy;
  }
  if (pairs != nullptr) {
    for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
    if (lane == 0) atomicAdd((int*)red, count);
    __syncthreads();
    if (tid == 0) pairs[blockIdx.x] += *(int*)red;
  }
}

extern "C" int pairforce_cull_launch(const void* pos, const void* ent, void* force, void* pairs,
                                     int B, int E, float k, float cf, float width,
                                     void* stream) {
  if (B == 0 || E == 0) return 0;
  int threads = ((E + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = pairforce_cull_smem_bytes(E);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairforce_cull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pairforce_cull_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)ent, (float*)force, (int*)pairs, E, k, cf, width);
  return (int)cudaGetLastError();
}
