// The score step of K2's wgmma kernels (sage_fwd_sm90_d64.cu and
// sage_fwd_sm90.cu), on the int32 accumulator of a wgmma m64n128k32 Q K^T
// (the f32 layout of sm90.cuh: element i of a thread at column
// 8 (i / 4) + 2t + (i & 1), rows g for i % 4 < 2 and g + 8 else): the exact
// conversion to f32, the mask, and the running-max online softmax in the
// log2 domain, p = 2^(s sqk - m) in place, each value's f32 bits in the
// accumulator's registers (no second array of 64).

#pragma once

#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace sage {

// The int32 scores as f32 in place; keys at or past `valid` (of the tile's
// 128) selected to -1e30. t = lane % 4.
__device__ __forceinline__ void convert(uint32_t (&sc)[64], int valid, int t) {
  if (valid < 128) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      sc[i] = __float_as_uint(col < valid ? sm90::s32_to_f32(sc[i]) : vap::kNegInf);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = __float_as_uint(sm90::s32_to_f32(sc[i]));
  }
}

// The online softmax of f32 scores: the new running max m in the log2
// domain (the scores' max times sqk), p = 2^(s sqk - m) in place (f32), and
// the factor alpha[r] that rescales O and l of row r.
__device__ __forceinline__ void softmax(uint32_t (&sc)[64], float (&m)[2], float sqk,
                                        float (&alpha)[2]) {
  float mx0 = vap::kNegInf, mx1 = vap::kNegInf;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    mx0 = fmaxf(mx0, fmaxf(__uint_as_float(sc[4 * c]), __uint_as_float(sc[4 * c + 1])));
    mx1 = fmaxf(mx1, fmaxf(__uint_as_float(sc[4 * c + 2]), __uint_as_float(sc[4 * c + 3])));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float n0 = fmaxf(m[0], mx0 * sqk), n1 = fmaxf(m[1], mx1 * sqk);
  alpha[0] = sm90::ex2(m[0] - n0);
  alpha[1] = sm90::ex2(m[1] - n1);
  m[0] = n0;
  m[1] = n1;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    sc[4 * c] = __float_as_uint(sm90::ex2(fmaf(__uint_as_float(sc[4 * c]), sqk, -n0)));
    sc[4 * c + 1] = __float_as_uint(sm90::ex2(fmaf(__uint_as_float(sc[4 * c + 1]), sqk, -n0)));
    sc[4 * c + 2] = __float_as_uint(sm90::ex2(fmaf(__uint_as_float(sc[4 * c + 2]), sqk, -n1)));
    sc[4 * c + 3] = __float_as_uint(sm90::ex2(fmaf(__uint_as_float(sc[4 * c + 3]), sqk, -n1)));
  }
}

}  // namespace sage
