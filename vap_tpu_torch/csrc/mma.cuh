// Warp-level tensor-core helpers shared by the attention kernels.
//
// Fragment layouts follow the PTX ISA for mma.sync (warp of 32 lanes,
// g = lane / 4, t = lane % 4):
//   m16n8k16 bf16  A (16x16, row): reg0 = (g, 2t..2t+1), reg1 = (g+8, 2t..),
//                                  reg2 = (g, 8+2t..),   reg3 = (g+8, 8+2t..)
//                  B (16x8, col):  reg0 = (k 2t..2t+1, n g), reg1 = (k 8+2t.., n g)
//   m16n8k32 s8    A (16x32, row): reg0 = (g, 4t..4t+3), reg1 = (g+8, 4t..),
//                                  reg2 = (g, 16+4t..),  reg3 = (g+8, 16+4t..)
//                  B (32x8, col):  reg0 = (k 4t..4t+3, n g), reg1 = (k 16+4t.., n g)
//   C/D (16x8, f32 or s32): c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
// The lower-indexed element of a packed pair sits in the low bits.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vap {

// Masked-key score in the log2 domain. Finite, as in the TPU kernels
// (NEG_INF = -1e30): a running max that starts here never meets an
// inf - inf, so no NaN can arise even when a tile holds no valid key.
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
// K7's floor of the running max: -1e4 nats (flash_attention.py:154-158) in
// the log2 domain. A query with no valid key keeps m here, l == 0, and so a
// zero output row and the finite lse ln2 * m = -1e4.
constexpr float kVarlenFloorLog2 = -1e4f * 1.4426950408889634f;

// Valid keys of row bh: min(kv_lens[bh / heads], skv) clamped at 0 for K7,
// or skv when kv_lens is null.
__device__ __forceinline__ int kv_length(const int* kv_lens, size_t bh, int heads, int skv) {
  if (kv_lens == nullptr) return skv;
  return max(0, min(kv_lens[bh / heads], skv));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

// Copy one [kRows, kRowBytes] tile from global memory (rows of `row_bytes`
// bytes, `valid_rows` of them in range) into shared memory rows of
// `kSmemStride` bytes, zero-filling rows past the end. 16-byte vectors.
template <int kRows, int kRowBytes, int kSmemStride, int kThreads>
__device__ __forceinline__ void load_tile(char* smem, const char* gmem, int valid_rows) {
  constexpr int kVecs = kRowBytes / 16;
  for (int i = threadIdx.x; i < kRows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 16;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid_rows) val = *reinterpret_cast<const uint4*>(gmem + (size_t)r * kRowBytes + c);
    *reinterpret_cast<uint4*>(smem + r * kSmemStride + c) = val;
  }
}

// Write zeros to rows [row0, row1) of a [rows, D] bf16 matrix in global
// memory, 16 bytes a thread at a time (K7's backward: the dk and dv rows of
// a key tile that lies wholly past a sample's length).
template <int D, int kThreads>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* m, int row0, int row1) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < (row1 - row0) * kVecs; i += kThreads) {
    *reinterpret_cast<uint4*>(m + (size_t)(row0 + i / kVecs) * D + (i % kVecs) * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// One kv tile of the running-max online softmax for a warp's 16 query rows,
// shared by the bf16 and int8 kernels once their scores are in the log2
// domain. s[j][e]: the warp's [16, 64] score tile in C layout (masked keys
// already at kNegInf). Rescales acc/l by the max shift and accumulates
// P @ V, where P is rounded to bf16 and l sums the rounded P (the TPU
// kernels take the denominator from the same bf16 P through a ones row).
template <int D, int kBlockN, int kVStride>
__device__ __forceinline__ void softmax_pv_tile(float (&s)[kBlockN / 8][4], float m[2], float l[2],
                                                float (&acc)[D / 8][4],
                                                const __nv_bfloat16* v_s) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  const float alpha0 = exp2f(m[0] - mx[0]);
  const float alpha1 = exp2f(m[1] - mx[1]);
  m[0] = mx[0];
  m[1] = mx[1];
  l[0] *= alpha0;
  l[1] *= alpha1;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] *= alpha0;
    acc[i][1] *= alpha0;
    acc[i][2] *= alpha1;
    acc[i][3] *= alpha1;
  }

  // P as A fragments: S tile j = 2kc (+1) fills regs 0,1 (2,3) of chunk kc.
  uint32_t pa[kBlockN / 16][4];
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(exp2f(s[j][0] - m[0]), exp2f(s[j][1] - m[0]));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(exp2f(s[j][2] - m[1]), exp2f(s[j][3] - m[1]));
    l[0] += __low2float(lo) + __high2float(lo);
    l[1] += __low2float(hi) + __high2float(hi);
    pa[j / 2][(j & 1) * 2 + 0] = *reinterpret_cast<const uint32_t*>(&lo);
    pa[j / 2][(j & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }

  // acc += P V; B fragment (k = key, n = head dim) read from row-major V.
#pragma unroll
  for (int kc = 0; kc < kBlockN / 16; ++kc) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const __nv_bfloat16* vr = v_s + (kc * 16 + 2 * t) * kVStride + i * 8 + g;
      const uint32_t b0 = pack_bf16(vr[0], vr[kVStride]);
      const uint32_t b1 = pack_bf16(vr[8 * kVStride], vr[9 * kVStride]);
      mma_bf16_16816(acc[i], pa[kc], b0, b1);
    }
  }
}

// Normalise and store the warp's 16 output rows and their natural-log lse.
template <int D>
__device__ __forceinline__ void store_rows(float (&acc)[D / 8][4], const float m[2], float l[2],
                                           __nv_bfloat16* o, float* lse, int row0, int sq) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= sq) continue;
    const float l_safe = l[r] == 0.0f ? 1.0f : l[r];  // the TPU kernels' l == 0 guard
    const float inv = 1.0f / l_safe;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const __nv_bfloat162 val =
          __floats2bfloat162_rn(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * D + i * 8 + 2 * t) = val;
    }
    if (t == 0) lse[row] = kLn2 * (m[r] + log2f(l_safe));
  }
}

}  // namespace vap
