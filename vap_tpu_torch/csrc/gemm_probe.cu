// K9 and K10: the tiled GEMM rate probe. out = x @ w^T with int8 inputs and
// an int32 result, or bf16 inputs, f32 accumulation and a bf16 result.
//
// Replaces the TPU kernels of scripts/linear_bench.py `run` (`dot_kernel`,
// K9: x as [M, K]) and `run_t` (`dot_t_kernel`, K10: x given transposed as
// xt [K, M]). They measure the tensor-core rate of a plain tiled product,
// outside any model path: K3 (w8a8.cu) is this GEMM plus a quantise pass
// and a per-chunk f32 fold. The weight is [N, K], K contiguous: the layout
// the port keeps its projection weights in (the TPU script's w is [K, N]).
//
// Design: the main loop of gemm.cuh (128 x 128 output tiles, 8 warps of
// 64 x 32, 64-byte K tiles double-buffered with cp.async) templated on the
// input type and on the layout of x; with xt the A tile is transposed
// through registers on its way into shared memory. No TPU block sizes are
// carried over; the probe script prints the tile. What bounds it on an
// H100 at the script's shape (M = 71,168, K = N = 3,072): operations, 2MNK
// at 1,979 TOP/s int8 (0.679 ms) or 989 TFLOP/s bf16 (1.358 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

using namespace vap::gemm;

template <typename T, bool kTransA>
__global__ void __launch_bounds__(kThreads) gemm_probe_kernel(const T* __restrict__ a,
                                                              const T* __restrict__ b,
                                                              void* __restrict__ out, int m,
                                                              int n, int k) {
  using AccT = typename Acc<T>::type;
  __shared__ __align__(16) char smem[kSmemBytes];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  const int g = lane >> 2, t = lane & 3;

  AccT acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int nk = k * static_cast<int>(sizeof(T)) / kBKBytes;
  mainloop<T, kTransA>(acc, smem, a, b, m, n, k, m0, n0, nk + 1,
                       [](AccT(&)[kMT][kNT][4], int) {});

#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + wm * kWarpM + mi * 16 + g + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const size_t at = (size_t)row * n + n0 + wn * kWarpN + ni * 8 + 2 * t;
        if constexpr (sizeof(T) == 1) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + at) =
              make_int2(acc[mi][ni][2 * r], acc[mi][ni][2 * r + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
              __floats2bfloat162_rn(acc[mi][ni][2 * r], acc[mi][ni][2 * r + 1]);
        }
      }
    }
}

template <typename T, bool kTransA>
cudaError_t launch(const void* a, const void* b, void* out, int m, int n, int k,
                   cudaStream_t stream) {
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  gemm_probe_kernel<T, kTransA><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound from Python with ctypes. a: x [m, k] (trans_a 0) or
// xt [k, m] (trans_a 1); b: w [n, k]; out [m, n] int32 (bf16 0) or bf16
// (bf16 1); all contiguous. Needs k a multiple of 64, n of 128, m of 16
// when trans_a, 1 <= m <= 65535 * 128. Returns the CUDA error of the launch.
extern "C" int vap_gemm_probe(const void* a, const void* b, void* out, int m, int n, int k,
                              int bf16, int trans_a, void* stream) {
  if (m < 1 || k < 64 || k % 64 || n < kBN || n % kBN || (trans_a && m % 16) ||
      (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return trans_a ? launch<__nv_bfloat16, true>(a, b, out, m, n, k, s)
                   : launch<__nv_bfloat16, false>(a, b, out, m, n, k, s);
  return trans_a ? launch<int8_t, true>(a, b, out, m, n, k, s)
                 : launch<int8_t, false>(a, b, out, m, n, k, s);
}
