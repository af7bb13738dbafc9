// K1: bf16 flash-attention forward for head_dim < 128 (multiple of 16).
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_forward_t` (`_fwd_kernel_t`, `_fwd_kernel_t_bound`).
// Same contract: q [BH, Sq, D], k/v [BH, Skv, D] bf16 -> out [BH, Sq, D] bf16
// and the natural-log lse [BH, Sq] f32, non-causal, keys past Skv masked.
// It computes the running-max online softmax; the TPU's bound form is the
// same function with another reference point.
//
// Design. One thread block per (bh, 64-query tile), four warps of 16 query
// rows; a loop over 64-key tiles inside the block takes the place of the
// TPU's sequential grid axis. Q stays in registers as mma A fragments; each
// kv tile is staged through shared memory; QK^T and PV run on the tensor
// cores as mma.sync m16n8k16 with f32 accumulation; the softmax stays in
// registers (the m16n8 C layout of S is reused as the A layout of P).
//
// What bounds it on an H100: at the main-path shape (S = 35,552, D = 64)
// attention does ~16 FLOP per byte of K/V read per query tile, so it is
// compute bound; this first kernel is limited by mma.sync issue rate, the
// un-pipelined global->shared copies (no cp.async/TMA yet) and the exp2
// work per score. wgmma with a TMA producer warp is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int sq, int skv, float scale_log2) {
  constexpr int kStride = D + 8;  // bf16 elements per smem row; the pad spreads banks
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockM + warp * 16;

  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * skv * D;
  const __nv_bfloat16* vb = v + bh * skv * D;

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + 8 * (r & 1);
      const int col = c * 16 + 2 * t + 8 * (r >> 1);
      qa[c][r] = row < sq ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * D + col) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m[2] = {vap::kNegInf, vap::kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    const int valid = min(kBlockN, skv - n0);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(k_s), reinterpret_cast<const char*>(kb + (size_t)n0 * D), valid);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(v_s), reinterpret_cast<const char*>(vb + (size_t)n0 * D), valid);
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const __nv_bfloat16* kr = k_s + (j * 8 + g) * kStride + c * 16 + 2 * t;
        vap::mma_bf16_16816(s[j], qa[c], *reinterpret_cast<const uint32_t*>(kr),
                            *reinterpret_cast<const uint32_t*>(kr + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        s[j][e] = col < valid ? s[j][e] * scale_log2 : vap::kNegInf;
      }
    }
    vap::softmax_pv_tile<D, kBlockN, kStride>(s, m, l, acc, v_s);
  }
  vap::store_rows<D>(acc, m, l, o + bh * sq * D, lse + bh * sq, row0, sq);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
                   int skv, float scale_log2, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, skv,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound from Python with ctypes. Tensors are contiguous
// [bh, s, d]; scale_log2 = softmax scale * log2(e). Returns the CUDA error
// of the launch (0 on success). bh <= 65535, sq >= 1.
extern "C" int vap_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int sq, int skv, int d, float scale_log2, void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, l, bh, sq, skv, scale_log2, s);
    case 32: return launch<32>(q, k, v, o, l, bh, sq, skv, scale_log2, s);
    case 48: return launch<48>(q, k, v, o, l, bh, sq, skv, scale_log2, s);
    case 64: return launch<64>(q, k, v, o, l, bh, sq, skv, scale_log2, s);
    case 80: return launch<80>(q, k, v, o, l, bh, sq, skv, scale_log2, s);
    case 96: return launch<96>(q, k, v, o, l, bh, sq, skv, scale_log2, s);
    case 112: return launch<112>(q, k, v, o, l, bh, sq, skv, scale_log2, s);
    default: return cudaErrorInvalidValue;
  }
}
