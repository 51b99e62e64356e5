// A check of common.cuh's branch-free square root and division
// (sqrt_rn_fast, div_rn_core, div_rn_fast) against the CUDA intrinsics __fsqrt_rn and
// __fdiv_rn, bit for bit, wherever their range tests pass.  Used by the card
// tests (tests/test_torch_cuda.py); no kernel of a path launches it.
//
// Modes, over the indices [off, off + count):
//   0  the root of the float with bits i (every float, over 2^32 indices)
//   1  x / 3, 2  x / 4, 3  x / 9, x the float with bits i (div_rn_core)
//   4  x / y for random x and y from index i: exponents over the range
//      tests' whole span and beyond (x down to subnormals and zero), random
//      significands; one y in eight has an all-ones significand and one in
//      eight a zero one (div_rn_core and div_rn_fast, each on its range)
//   5  x / y for every x below 2^-63 (subnormals and zero included, both
//      signs: 2^30 values) and each of 16 divisors (DIVISORS; div_rn_fast)
// out[0] counts the mismatches, out[1] the operands in range.

#include "common.cuh"

namespace {

// contact distances about the clamp, the penalty's tail and one agent size,
// the means' 3, 4 and 9, an all-ones significand, the range's ends
__constant__ float DIVISORS[16] = {1e-12f, 1e-6f,  1e-3f, 0.0625f, 0.1f,        0.13f,
                                   0.147f, 0.16f, 0.5f,  3.0f,    4.0f,        9.0f,
                                   1000.0f, 1.99999988f, 0x1p-63f, 0x1.fffffep63f};

__global__ void rn_fast_check_kernel(int mode, unsigned long long off, unsigned long long count,
                                     unsigned long long* out) {
  const unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
  if (i >= count) return;
  const unsigned long long k = off + i;
  bool ok = false, bad = false;
  if (mode == 0) {
    const float x = __uint_as_float((unsigned)k);
    ok = sqrt_rn_fast_ok(x);
    bad = ok && __float_as_uint(sqrt_rn_fast(x)) != __float_as_uint(__fsqrt_rn(x));
  } else if (mode <= 3) {
    const float x = __uint_as_float((unsigned)k), y = mode == 1 ? 3.0f : mode == 2 ? 4.0f : 9.0f;
    ok = div_rn_core_ok(x, y);
    bad = ok && __float_as_uint(div_rn_core(x, y)) != __float_as_uint(__fdiv_rn(x, y));
  } else if (mode == 4) {
    const unsigned h1 = hash_u32((unsigned)k * 2u + 1u), h2 = hash_u32(((unsigned)k * 2u + 2u) ^ 0x9E3779B9u);
    const unsigned ex = (h1 >> 24) % 220u, ey = 55u + (h2 >> 24) % 145u;
    const unsigned my = (h1 & 7u) == 0u ? 0x7fffffu : (h1 & 7u) == 1u ? 0u : (h2 & 0x7fffffu);
    const float x = __uint_as_float((h1 & 0x80000000u) | (ex << 23) | (h1 & 0x7fffffu));
    const float y = __uint_as_float(((h2 << 8) & 0x80000000u) | (ey << 23) | my);
    const unsigned want = __float_as_uint(__fdiv_rn(x, y));
    ok = div_rn_fast_ok(x, y);
    bad = (ok && __float_as_uint(div_rn_fast(x, y)) != want) ||
          (div_rn_core_ok(x, y) && __float_as_uint(div_rn_core(x, y)) != want);
  } else {
    const unsigned bits = (unsigned)(k & 0x3fffffffull);  // |x| < 2^-63, the sign in bit 29
    const float x = __uint_as_float((bits & 0x1fffffffu) | ((bits >> 29) << 31));
    const float y = DIVISORS[(k >> 30) & 15];
    ok = div_rn_fast_ok(x, y);
    bad = ok && __float_as_uint(div_rn_fast(x, y)) != __float_as_uint(__fdiv_rn(x, y));
  }
  const unsigned m = __activemask();
  const int nbad = __popc(__ballot_sync(m, bad)), nok = __popc(__ballot_sync(m, ok));
  if ((threadIdx.x & 31) == __ffs(m) - 1) {
    if (nbad) atomicAdd(out, (unsigned long long)nbad);
    if (nok) atomicAdd(out + 1, (unsigned long long)nok);
  }
}

}  // namespace

extern "C" int rn_fast_check_launch(int mode, unsigned long long off, unsigned long long count,
                                    void* out, void* stream) {
  if (mode < 0 || mode > 5) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  const unsigned long long blocks = (count + 255) / 256;
  rn_fast_check_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      mode, off, count, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
