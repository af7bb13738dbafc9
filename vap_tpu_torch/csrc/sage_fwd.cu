// K2: SageAttention-style forward, int8 QK^T with int32 accumulation and
// bf16 PV, for head_dim % 32 == 0 (up to 96).
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_forward_t_i8` (`_fwd_kernel_t_i8`, `_fwd_kernel_t_i8_bound`).
// The quantisation pre-pass (K smoothing, one symmetric int8 scale per (b,h)
// for Q and for K) runs in PyTorch in the wrapper, as it ran in XLA outside
// the Pallas kernel. The kernel takes q8 [BH, Sq, D] and k8 [BH, Skv, D]
// int8, v [BH, Skv, D] bf16 and sqk [BH] f32 (s_q * s_k * scale * log2 e),
// and returns out [BH, Sq, D] bf16 and the natural-log lse [BH, Sq] f32.
// Scores are int32 dot products times sqk, which lands them in the log2
// domain of the running-max online softmax; keys past Skv are masked.
//
// Design: as flash_fwd.cu (one block per (bh, 64-query tile), four warps,
// a loop over 64-key tiles), with QK^T on the int8 tensor cores as
// mma.sync m16n8k32 s8 -> s32 at twice the bf16 rate, and PV as bf16
// m16n8k16. What bounds it on an H100 is the same as for K1, minus half of
// the QK^T issue time and half of the K bytes per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads) sage_fwd_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ k8, const float* __restrict__ sqk,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int sq, int skv) {
  constexpr int kKStride = D + 16;  // bytes per int8 smem row; the pad spreads banks
  constexpr int kVStride = D + 8;   // bf16 elements per smem row
  __shared__ __align__(16) int8_t k_s[kBlockN * kKStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kVStride];

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kBlockM + warp * 16;
  const float scale = sqk[bh];

  const int8_t* qb = q8 + bh * sq * D;
  const int8_t* kb = k8 + bh * skv * D;
  const __nv_bfloat16* vb = v + bh * skv * D;

  uint32_t qa[D / 32][4];
#pragma unroll
  for (int c = 0; c < D / 32; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + 8 * (r & 1);
      const int col = c * 32 + 4 * t + 16 * (r >> 1);
      qa[c][r] = row < sq ? *reinterpret_cast<const uint32_t*>(qb + (size_t)row * D + col) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m[2] = {vap::kNegInf, vap::kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int n0 = 0; n0 < skv; n0 += kBlockN) {
    __syncthreads();
    const int valid = min(kBlockN, skv - n0);
    vap::load_tile<kBlockN, D, kKStride, kThreads>(
        reinterpret_cast<char*>(k_s), reinterpret_cast<const char*>(kb + (size_t)n0 * D), valid);
    vap::load_tile<kBlockN, D * 2, kVStride * 2, kThreads>(
        reinterpret_cast<char*>(v_s), reinterpret_cast<const char*>(vb + (size_t)n0 * D), valid);
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      int si[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const int8_t* kr = k_s + (j * 8 + g) * kKStride + c * 32 + 4 * t;
        vap::mma_s8_16832(si, qa[c], *reinterpret_cast<const uint32_t*>(kr),
                          *reinterpret_cast<const uint32_t*>(kr + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        s[j][e] = col < valid ? static_cast<float>(si[e]) * scale : vap::kNegInf;
      }
    }
    vap::softmax_pv_tile<D, kBlockN, kVStride>(s, m, l, acc, v_s);
  }
  vap::store_rows<D>(acc, m, l, o + bh * sq * D, lse + bh * sq, row0, sq);
}

template <int D>
cudaError_t launch(const void* q8, const void* k8, const void* sqk, const void* v, void* o,
                   float* lse, int bh, int sq, int skv, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  sage_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const float*>(sqk), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), lse, sq, skv);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound from Python with ctypes. Tensors are contiguous
// [bh, s, d] (sqk: [bh]). Returns the CUDA error of the launch (0 on
// success). bh <= 65535, sq >= 1.
extern "C" int vap_sage_fwd(const void* q8, const void* k8, const void* sqk, const void* v,
                            void* o, void* lse, int bh, int sq, int skv, int d, void* stream) {
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q8, k8, sqk, v, o, l, bh, sq, skv, s);
    case 64: return launch<64>(q8, k8, sqk, v, o, l, bh, sq, skv, s);
    case 96: return launch<96>(q8, k8, sqk, v, o, l, bh, sq, skv, s);
    default: return cudaErrorInvalidValue;
  }
}
