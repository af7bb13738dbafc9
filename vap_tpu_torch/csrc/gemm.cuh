// A tiled mma.sync GEMM main loop shared by K3 (w8a8.cu) and the K9/K10
// rate probe (gemm_probe.cu): C[M, N] += A[M, K] B[N, K]^T with int8 x int8
// -> int32 (mma m16n8k32) or bf16 x bf16 -> f32 (mma m16n8k16).
//
// One block of 256 threads (8 warps as 2 x 4) computes a 128 x 128 output
// tile; each warp a 64 x 32 piece, 4 x 4 mma tiles. K goes in tiles of 64
// bytes (64 int8 or 32 bf16 values), double-buffered in shared memory with
// cp.async, so the copy of tile k+1 overlaps the products of tile k. Shared
// rows are 80 bytes apart, which puts the 32-bit fragment loads of a warp on
// 32 distinct banks. Counted in bytes, the A and B fragment layouts of
// m16n8k32 s8 and m16n8k16 bf16 are the same (mma.cuh), so one loader and
// one fragment walk serve both types.
//
// B is [N, K] with K contiguous (the col operand as it lies). A is [M, K]
// row-major, or, with kTransA, given transposed as [K, M]: its tile then
// goes through registers and is transposed element by element on the way
// into shared memory. Rows of A past M are zero-filled (cp.async with a
// source size of 0), so M may be ragged; K must be a multiple of 64 bytes
// and N of 128.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace vap {
namespace gemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBKBytes = 64;
constexpr int kStride = kBKBytes + 16;  // bytes per shared row
constexpr int kThreads = 256;
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;  // mma tiles per warp along M
constexpr int kNT = kWarpN / 8;   // and along N
constexpr int kTileBytes = kBM * kStride;
constexpr int kSmemBytes = 2 * 2 * kTileBytes;  // [buffer][A, B]: 40 KB

template <typename T>
struct Acc;
template <>
struct Acc<int8_t> {
  using type = int;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  mma_s8_16832(c, a, b0, b1);
}
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  mma_bf16_16816(c, a, b0, b1);
}

__device__ __forceinline__ void cp_async16(char* smem, const char* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ uint32_t ld32(const char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 128 rows x 64 bytes from row-major global memory (rows of `ld` bytes,
// starting at row r0 and byte c0; rows at or past `rows` zero-filled).
__device__ __forceinline__ void load_rows_async(char* smem, const char* g, size_t ld, int r0,
                                                int rows, size_t c0) {
#pragma unroll
  for (int i = threadIdx.x; i < kBM * (kBKBytes / 16); i += kThreads) {
    const int r = i / (kBKBytes / 16), c = (i % (kBKBytes / 16)) * 16;
    const bool valid = r0 + r < rows;
    cp_async16(smem + r * kStride + c, g + (size_t)(valid ? r0 + r : 0) * ld + c0 + c, valid);
  }
}

// The transposed A tile: kBKBytes / E rows of k, each 128 values of m
// (16-byte vectors; M a multiple of 16, so a vector is all in range or all
// out of it). Global -> registers ...
template <typename T>
__device__ __forceinline__ void load_t_regs(uint4 (&r)[2], const char* xt, size_t ld, int m0,
                                            int m, int k0) {
  constexpr int E = sizeof(T);
  constexpr int kVecsPerRow = kBM * E / 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int kr = i / kVecsPerRow, mc = (i % kVecsPerRow) * (16 / E);
    r[j] = make_uint4(0, 0, 0, 0);
    if (m0 + mc < m)
      r[j] = *reinterpret_cast<const uint4*>(xt + (size_t)(k0 + kr) * ld + (size_t)(m0 + mc) * E);
  }
}

// ... and registers -> shared [m][k], one value at a time.
template <typename T>
__device__ __forceinline__ void store_t_regs(char* smem, const uint4 (&r)[2]) {
  constexpr int E = sizeof(T);
  constexpr int kVecsPerRow = kBM * E / 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int kr = i / kVecsPerRow, mc = (i % kVecsPerRow) * (16 / E);
    const T* v = reinterpret_cast<const T*>(&r[j]);
#pragma unroll
    for (int q = 0; q < 16 / E; ++q)
      *reinterpret_cast<T*>(smem + (mc + q) * kStride + kr * E) = v[q];
  }
}

// The products of one shared tile pair: two 32-byte k steps, 4 x 4 mma each.
template <typename T>
__device__ __forceinline__ void mma_tile(typename Acc<T>::type (&acc)[kMT][kNT][4],
                                         const char* as, const char* bs, int wm, int wn) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBKBytes / 32; ++ks) {
    uint32_t a[kMT][4], b[kNT][2];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const char* p = as + (wm * kWarpM + mi * 16 + g) * kStride + ks * 32 + 4 * t;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * kStride);
      a[mi][2] = ld32(p + 16);
      a[mi][3] = ld32(p + 8 * kStride + 16);
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const char* p = bs + (wn * kWarpN + ni * 8 + g) * kStride + ks * 32 + 4 * t;
      b[ni][0] = ld32(p);
      b[ni][1] = ld32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// The main loop of the block's tile (m0, n0) over all of K. After every
// `tiles_per_fold` K tiles, fold(acc, index of the fold) runs on every
// thread (K3 folds its int32 sums into f32 there, per quantisation chunk).
template <typename T, bool kTransA, typename Fold>
__device__ __forceinline__ void mainloop(typename Acc<T>::type (&acc)[kMT][kNT][4], char* smem,
                                         const T* a, const T* b, int m, int n, int k, int m0,
                                         int n0, int tiles_per_fold, Fold fold) {
  constexpr int E = sizeof(T);
  const char* ag = reinterpret_cast<const char*>(a);
  const char* bg = reinterpret_cast<const char*>(b);
  const size_t lda = kTransA ? (size_t)m * E : (size_t)k * E;
  const size_t ldb = (size_t)k * E;
  const int nk = k * E / kBKBytes;
  const int warp = threadIdx.x / 32;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  uint4 treg[2];

  if (kTransA)
    load_t_regs<T>(treg, ag, lda, m0, m, 0);
  else
    load_rows_async(smem, ag, lda, m0, m, 0);
  load_rows_async(smem + kTileBytes, bg, ldb, n0, n, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    char* as = smem + (kt & 1) * 2 * kTileBytes;
    if (kTransA) store_t_regs<T>(as, treg);
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < nk) {
      char* next = smem + ((kt + 1) & 1) * 2 * kTileBytes;
      const size_t kb = (size_t)(kt + 1) * kBKBytes;
      if (kTransA)
        load_t_regs<T>(treg, ag, lda, m0, m, (kt + 1) * (kBKBytes / E));
      else
        load_rows_async(next, ag, lda, m0, m, kb);
      load_rows_async(next + kTileBytes, bg, ldb, n0, n, kb);
      cp_async_commit();
    }
    mma_tile<T>(acc, as, as + kTileBytes, wm, wn);
    if ((kt + 1) % tiles_per_fold == 0) fold(acc, kt / tiles_per_fold);
  }
}

}  // namespace gemm
}  // namespace vap
