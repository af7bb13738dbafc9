// K5: bf16 flash-attention backward at head_dim < 128.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_backward_t` (`_bwd_dq_kernel_t`, `_bwd_dkv_kernel_t`):
// the gradient of out = softmax(q k^T * scale) v over [BH, S, D], non-causal,
// keys past Skv masked. P is recomputed from the natural-log lse that K1
// saved (lse2 = lse * log2(e)); delta = rowsum(out * dout) comes in from the
// wrapper, f32. The rounding points are the TPU kernels': ds = p (dp - delta)
// is rounded to bf16 before both products it enters, and p is rounded to
// bf16 for dv = p^T dout.
//
// Design. Two kernels, as on the TPU, so that every sum is made in one
// block and comes out the same from run to run (no atomics):
//   dq:  one block per (bh, 64-query tile), four warps of 16 query rows, a
//        loop over 64-key tiles. Q and dout stay in registers as mma A
//        fragments; K and V tiles are staged through shared memory.
//        s = q k^T, dp = dout v^T, ds = p (dp - delta); dq += ds k.
//   dkv: one block per (bh, 64-key tile), four warps of 16 key rows, a loop
//        over 64-query tiles. K and V stay in registers; Q and dout tiles,
//        with their lse and delta, are staged through shared memory. The
//        scores are computed transposed (s^T = k q^T, dp^T = v dout^T), so
//        their C layout is the A layout of dv += p^T dout and dk += ds^T q.
// All five products run on the tensor cores as mma.sync m16n8k16 with f32
// accumulation. A masked key gets p = 0 in the dq kernel; a padded query
// row of the last tile is zero-filled with lse2 = +1e30, so its p is 0 and
// it adds nothing to dk and dv (the TPU's padded lse rows).
//
// What bounds it on an H100: 10*B*H*Sq*Skv*D FLOP (five products) against
// about 2*(3*Sq + 2*Skv)*D bytes of bf16 operands per (b,h); at the main
// path's [1, 48, 35552, 64] that is 39.3 ms of bf16 tensor-core time against
// 1.4 ms of memory traffic, so it is compute bound. This first kernel is
// limited by mma.sync issue rate, the scalar shared-memory reads of the
// transposed B operands, the un-pipelined global->shared copies and the
// exp2 work per score; wgmma with TMA is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;  // queries per tile
constexpr int kBlockN = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse2 = 1e30f;  // lse2 of a padded query row: p = exp2(s - 1e30) = 0

// A fragments of a warp's 16 rows [row0, row0 + 16) of a [rows, D] bf16
// matrix in global memory; rows at or past `rows` read as zero.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* m, int row0,
                                       int rows) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + 8 * (r & 1);
      const int col = c * 16 + 2 * t + 8 * (r >> 1);
      a[c][r] = row < rows ? *reinterpret_cast<const uint32_t*>(m + (size_t)row * D + col) : 0u;
    }
  }
}

// c[16, 64] = a[16, D] . b^T, b a [64, D] row-major shared-memory tile whose
// rows are the n index (as K in q k^T).
template <int D, int kStride>
__device__ __forceinline__ void mma_abt(float (&c)[kBlockN / 8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* b_s) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < D / 16; ++cc) {
      const __nv_bfloat16* br = b_s + (j * 8 + g) * kStride + cc * 16 + 2 * t;
      vap::mma_bf16_16816(c[j], a[cc], *reinterpret_cast<const uint32_t*>(br),
                          *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// acc[16, D] += a[16, 64] . b, a given as A fragments, b a [64, D]
// row-major shared-memory tile whose rows are the k index (as V in p v).
template <int D, int kStride>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[kBlockN / 16][4],
                                       const __nv_bfloat16* b_s) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kBlockN / 16; ++kc) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const __nv_bfloat16* br = b_s + (kc * 16 + 2 * t) * kStride + i * 8 + g;
      const uint32_t b0 = vap::pack_bf16(br[0], br[kStride]);
      const uint32_t b1 = vap::pack_bf16(br[8 * kStride], br[9 * kStride]);
      vap::mma_bf16_16816(acc[i], a[kc], b0, b1);
    }
  }
}

// Round a [16, 64] C-layout tile to bf16 A fragments (n-tile j = 2kc (+1)
// fills regs 0,1 (2,3) of chunk kc).
__device__ __forceinline__ void c_to_a(uint32_t (&a)[kBlockN / 16][4], const float (&c)[kBlockN / 8][4]) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(c[j][0], c[j][1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(c[j][2], c[j][3]);
    a[j / 2][(j & 1) * 2 + 0] = *reinterpret_cast<const uint32_t*>(&lo);
    a[j / 2][(j & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
}

// Store a warp's 16 rows of acc * mul as bf16 (rows at or past `rows` skipped).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, __nv_bfloat16* m,
                                           int row0, int rows) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(m + (size_t)row * D + i * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int sq, int skv, float scale_log2, float scale) {
  constexpr int kStride = D + 8;  // bf16 elements per smem row; the pad spreads banks
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockM + warp * 16;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, q + bh * sq * D, row0, sq);
  load_a<D>(da, dout + bh * sq * D, row0, sq);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse2[r] = row < sq ? lse[bh * sq + row] * kLog2e : kPadLse2;
    dl[r] = row < sq ? delta[bh * sq + row] : 0.0f;
  }
  const __nv_bfloat16* kb = k + bh * skv * D;
  const __nv_bfloat16* vb = v + bh * skv * D;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    const int valid = min(kBlockN, skv - n0);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(k_s), reinterpret_cast<const char*>(kb + (size_t)n0 * D), valid);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(v_s), reinterpret_cast<const char*>(vb + (size_t)n0 * D), valid);
    __syncthreads();

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
    mma_abt<D, kStride>(s, qa, k_s);
    mma_abt<D, kStride>(dp, da, v_s);
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float p = col < valid ? exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) : 0.0f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // ds, in place of s
      }
    }
    uint32_t dsa[kBlockN / 16][4];
    c_to_a(dsa, s);
    mma_ab<D, kStride>(acc, dsa, k_s);
  }
  store_rows<D>(acc, scale, dq + bh * sq * D, row0, sq);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int sq, int skv, float scale_log2, float scale) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 do_s[kBlockM * kStride];
  __shared__ float lse2_s[kBlockM];
  __shared__ float dl_s[kBlockM];

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kBlockN + warp * 16;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + bh * skv * D, key0, skv);
  load_a<D>(va, v + bh * skv * D, key0, skv);
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* db = dout + bh * sq * D;
  const float* lb = lse + bh * sq;
  const float* deb = delta + bh * sq;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.0f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.0f;
  }

  for (int m0 = 0; m0 < sq; m0 += kBlockM) {
    __syncthreads();
    const int valid = min(kBlockM, sq - m0);
    vap::load_tile<kBlockM, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(q_s), reinterpret_cast<const char*>(qb + (size_t)m0 * D), valid);
    vap::load_tile<kBlockM, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(do_s), reinterpret_cast<const char*>(db + (size_t)m0 * D), valid);
    for (int i = threadIdx.x; i < kBlockM; i += kThreads) {
      lse2_s[i] = i < valid ? lb[m0 + i] * kLog2e : kPadLse2;
      dl_s[i] = i < valid ? deb[m0 + i] : 0.0f;
    }
    __syncthreads();

    // transposed scores: rows are the warp's keys, columns the tile's queries
    float s[kBlockM / 8][4], dp[kBlockM / 8][4];
    mma_abt<D, kStride>(s, ka, q_s);
    mma_abt<D, kStride>(dp, va, do_s);
#pragma unroll
    for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float p = exp2f(fmaf(s[j][e], scale_log2, -lse2_s[col]));
        dp[j][e] = p * (dp[j][e] - dl_s[col]);  // ds^T, in place of dp^T
        s[j][e] = p;
      }
    }
    uint32_t pa[kBlockM / 16][4], dsa[kBlockM / 16][4];
    c_to_a(pa, s);
    c_to_a(dsa, dp);
    mma_ab<D, kStride>(dv_acc, pa, do_s);
    mma_ab<D, kStride>(dk_acc, dsa, q_s);
  }
  store_rows<D>(dk_acc, scale, dk + bh * skv * D, key0, skv);
  store_rows<D>(dv_acc, 1.0f, dv + bh * skv * D, key0, skv);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, int bh, int sq, int skv,
                   float scale_log2, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dp = static_cast<const bf*>(dout);
  flash_bwd_dq_kernel<D><<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads, 0, stream>>>(
      qp, kp, vp, dp, lse, delta, static_cast<bf*>(dq), sq, skv, scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || skv == 0) return err;  // no key: dk and dv are empty
  flash_bwd_dkv_kernel<D><<<dim3((skv + kBlockN - 1) / kBlockN, bh), kThreads, 0, stream>>>(
      qp, kp, vp, dp, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), sq, skv,
      scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound from Python with ctypes. Tensors are contiguous
// [bh, s, d] bf16 (q, dout, dq: sq rows; k, v, dk, dv: skv rows), lse and
// delta [bh, sq] f32; scale_log2 = softmax scale * log2(e). Launches the dq
// kernel, then the dk/dv kernel, on `stream`, and returns the CUDA error of
// the launches (0 on success). bh <= 65535, sq >= 1, head_dim d in 16..112,
// step 16.
extern "C" int vap_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, void* dk, void* dv,
                             int bh, int sq, int skv, int d, float scale_log2, float scale,
                             void* stream) {
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, dout, l, de, dq, dk, dv, bh, sq, skv, scale_log2, scale, s);
    case 32: return launch<32>(q, k, v, dout, l, de, dq, dk, dv, bh, sq, skv, scale_log2, scale, s);
    case 48: return launch<48>(q, k, v, dout, l, de, dq, dk, dv, bh, sq, skv, scale_log2, scale, s);
    case 64: return launch<64>(q, k, v, dout, l, de, dq, dk, dv, bh, sq, skv, scale_log2, scale, s);
    case 80: return launch<80>(q, k, v, dout, l, de, dq, dk, dv, bh, sq, skv, scale_log2, scale, s);
    case 96: return launch<96>(q, k, v, dout, l, de, dq, dk, dv, bh, sq, skv, scale_log2, scale, s);
    case 112: return launch<112>(q, k, v, dout, l, de, dq, dk, dv, bh, sq, skv, scale_log2, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
