// K3: the W8A8 linear. y = (sum over K-chunks of (x_i8 w_i8^T)_c * s_x[:, c])
// * s_w + bias, in f32, written as bf16.
//
// Replaces the TPU kernel of vap_tpu/ops/int8_matmul.py `_w8a8_call`
// (`_w8a8_kernel`), and computes what it computes: per (row, chunk) of
// C = _pick(K, 1536) columns, amax = max(max|x|, 1e-8), x_i8 =
// rint(x * (127 / amax)) (the reciprocal divided once, then multiplied),
// s_x = amax * (1 / 127); each chunk's int32 partial is turned into f32,
// times its s_x, and added to an f32 sum in chunk order; the epilogue is
// acc * s_w + bias, rounded to bf16. The f32 steps use __fmul_rn /
// __fadd_rn, so no multiply-add is contracted and the sums round as the
// plain PyTorch version's do.
//
// Design: two launches.
//   1. w8a8_quantize_kernel: one warp per (row, chunk) finds amax, writes
//      x_i8 [M, K] and s_x [M, K / C].
//   2. w8a8_gemm_kernel: the tiled int8 mma.sync GEMM of gemm.cuh (128 x
//      128 tiles, 8 warps, cp.async double buffering), whose int32 fragments
//      are folded into f32 registers with each row's s_x at every chunk
//      boundary (|partial| <= 127^2 * 1536 < 2^31) and reset.
// The TPU kernel fuses the quantisation into the GEMM; the separate pass
// costs one more read of x and a write and read of x_i8, 0.33 GB at the
// [35552, 3072] shape, against an operations bound of 0.34 ms there.
// What bounds K3 on an H100: the int8 tensor-core rate, 2 * M * N * K
// operations at 1,979 TOP/s (0.339 ms at [35552, 3072] x [3072, 3072],
// 1.356 ms at K or N = 12288), above the bytes bound (0.133 / 0.337 ms).
// mma.sync reaches only part of that rate on Hopper; wgmma is a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

using namespace vap::gemm;

constexpr int kQuantWarps = 8;

__global__ void __launch_bounds__(kQuantWarps * 32) w8a8_quantize_kernel(
    const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int m,
    int k, int chunk) {
  const int nchunks = k / chunk;
  const long long item = (long long)blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (item >= (long long)m * nchunks) return;
  const int lane = threadIdx.x % 32;
  const int row = static_cast<int>(item / nchunks), c = static_cast<int>(item % nchunks);
  const size_t off = (size_t)row * k + (size_t)c * chunk;
  const __nv_bfloat16* src = x + off;

  float amax = 0.0f;
  for (int i = lane * 8; i < chunk; i += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  amax = fmaxf(amax, 1e-8f);
  const float r = __fdiv_rn(127.0f, amax);

  for (int i = lane * 8; i < chunk; i += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      const uint32_t q0 = static_cast<uint8_t>(static_cast<int8_t>(rintf(__fmul_rn(f.x, r))));
      const uint32_t q1 = static_cast<uint8_t>(static_cast<int8_t>(rintf(__fmul_rn(f.y, r))));
      packed[j / 2] |= (q0 | (q1 << 8)) << (16 * (j % 2));
    }
    *reinterpret_cast<uint2*>(xq + off + i) = make_uint2(packed[0], packed[1]);
  }
  if (lane == 0) sx[item] = __fmul_rn(amax, 1.0f / 127.0f);
}

__global__ void __launch_bounds__(kThreads) w8a8_gemm_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w, const float* __restrict__ sx,
    const float* __restrict__ sw, const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int m, int n, int k, int chunk) {
  __shared__ __align__(16) char smem[kSmemBytes];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nchunks = k / chunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  const int g = lane >> 2, t = lane & 3;

  int acc[kMT][kNT][4];
  float facc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0;
        facc[mi][ni][e] = 0.0f;
      }

  auto fold = [&](int (&a)[kMT][kNT][4], int c) {
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const int r0 = m0 + wm * kWarpM + mi * 16 + g;
      const float s0 = r0 < m ? sx[(size_t)r0 * nchunks + c] : 0.0f;
      const float s1 = r0 + 8 < m ? sx[(size_t)(r0 + 8) * nchunks + c] : 0.0f;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          facc[mi][ni][e] = __fadd_rn(facc[mi][ni][e],
                                      __fmul_rn(static_cast<float>(a[mi][ni][e]), e < 2 ? s0 : s1));
          a[mi][ni][e] = 0;
        }
    }
  };
  mainloop<int8_t, false>(acc, smem, xq, w, m, n, k, m0, n0, chunk / kBKBytes, fold);

#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm * kWarpM + mi * 16 + g + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int col = n0 + wn * kWarpN + ni * 8 + 2 * t;
        float y0 = __fmul_rn(facc[mi][ni][2 * r], sw[col]);
        float y1 = __fmul_rn(facc[mi][ni][2 * r + 1], sw[col + 1]);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, bias[col]);
          y1 = __fadd_rn(y1, bias[col + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
}

}  // namespace

// C entry point, bound from Python with ctypes. x [m, k] bf16, w [n, k]
// int8, sw [n] f32, bias [n] f32 or null; scratch xq [m, k] int8 and sx
// [m, k / chunk] f32; out [m, n] bf16; all contiguous. Needs chunk a
// multiple of 128 dividing k, n a multiple of 128, 1 <= m <= 65535 * 128.
// Returns the CUDA error of the launches (0 on success).
extern "C" int vap_w8a8(const void* x, const void* w, const void* sw, const void* bias,
                        void* xq, void* sx, void* out, int m, int n, int k, int chunk,
                        void* stream) {
  if (m < 1 || chunk < 128 || chunk % 128 || k % chunk || n < kBN || n % kBN ||
      (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long items = (long long)m * (k / chunk);
  w8a8_quantize_kernel<<<static_cast<unsigned>((items + kQuantWarps - 1) / kQuantWarps),
                         kQuantWarps * 32, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<int8_t*>(xq),
                                                   static_cast<float*>(sx), m, k, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  w8a8_gemm_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), m, n, k, chunk);
  return cudaGetLastError();
}
