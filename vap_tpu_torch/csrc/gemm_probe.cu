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
// Design: the wgmma main loop of gemm_sm90.cuh (TMA ring, a producer warp,
// two consumer warpgroups, 2-block clusters sharing the w tile by
// multicast, a persistent grid, stores staged through shared memory) at an
// output tile of 128 x 256: each consumer warpgroup computes m64n256, 128
// accumulator registers, in four stages of 48 KB (192 KB, with the 32 KB
// of output boxes). Three kernels, one per operand form:
//   gemm_probe_i8_kernel: x_i8 [M, K] and w_i8 K-major, int32 out;
//   gemm_probe_bf16_kernel: the same in bf16, f32 rounded to bf16 out;
//   gemm_probe_bf16_t_kernel: K10 in bf16, xt [K, M] read MN-major.
// 8-bit wgmma has no MN-major operand, so K10 in int8 is two launches:
// transpose_i8_kernel writes xt^T into a scratch [M, K] (the wrapper's),
// then gemm_probe_i8_kernel. What bounds it on an H100 at the script's
// shape (M = 71,168, K = N = 3,072): operations, 2MNK at 1,979 TOP/s int8
// (0.679 ms) or 989 TFLOP/s bf16 (1.358 ms); the transpose, bytes (2MK at
// 3.35 TB/s, 0.13 ms).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_sm90.cuh"
#include "sm90.cuh"

namespace {

using namespace vap::gemm90;

constexpr int kBN = 256;
constexpr int kStages = 4;
using ProbeRing = Ring<kBN, kStages>;

// The probe's consumer: one accumulator over all of K, stored at the end.
template <bool kInt8, bool kTransA>
struct ProbeBody {
  std::conditional_t<kInt8, uint32_t, float> acc[kBN / 2];
  OutStage<kBN, kInt8 ? 4 : 2> out;
  int band;  // this warpgroup's first row in a tile

  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ void chunk_begin(int, int) {}
  __device__ __forceinline__ void issue(uint32_t a, uint32_t b, bool first) {
    if constexpr (kInt8) {
      issue_stage(acc, a, b, first);
    } else {
      issue_stage_bf16<kTransA>(acc, a, b, first);
    }
  }
  __device__ __forceinline__ void chunk_end(int, int) { sm90::fence_regs(acc); }
  __device__ __forceinline__ void store(int m0, int n0) {
    using O = decltype(out);
#pragma unroll
    for (int bx = 0; bx < O::kBoxes; ++bx) {
      out.begin_box();
#pragma unroll
      for (int jj = 0; jj < O::kBoxPairs; ++jj) {
        const int j = bx * O::kBoxPairs + jj;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (kInt8) {
            out.put(jj, r, make_uint2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
          } else {
            out.put(jj, r, sm90::pack_bf16x2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]));
          }
        }
      }
      out.end_box(n0 + bx * O::kBoxCols, m0 + band);
    }
  }
};

template <bool kInt8, bool kTransA>
__device__ __forceinline__ void probe(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                      const CUtensorMap* map_out, int m, int n, int k,
                                      unsigned char* smem_raw) {
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const ProbeRing ring{base, smem};
  const TileWalk walk(m, n, kBN);
  constexpr int kElem = kInt8 ? 1 : 2;
  const int nk = (k * kElem + kBoxBytes - 1) / kBoxBytes;
  ring.init();
  if (threadIdx.x < 128) {  // the producer warpgroup
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      produce<kBN, kStages, 0, kElem, kTransA>(ring, map_a, map_b, walk, nk);
    }
  } else {  // the two consumer warpgroups
    sm90::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    ProbeBody<kInt8, kTransA> body;
    body.out = out_stage<kInt8 ? 4 : 2>(ring, w, map_out);
    body.band = 64 * w;
    consume(ring, walk, 1, nk, body);
    body.out.finish();
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    gemm_probe_i8_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ CUtensorMap map_out, int m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  probe<true, false>(&map_a, &map_b, &map_out, m, n, k, smem_raw);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    gemm_probe_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_out, int m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  probe<false, false>(&map_a, &map_b, &map_out, m, n, k, smem_raw);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    gemm_probe_bf16_t_kernel(const __grid_constant__ CUtensorMap map_a,
                             const __grid_constant__ CUtensorMap map_b,
                             const __grid_constant__ CUtensorMap map_out, int m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  probe<false, true>(&map_a, &map_b, &map_out, m, n, k, smem_raw);
}

// src [rows, cols] int8 -> dst [cols, rows], one 64 x 64 tile a block of 256
// threads: each thread reads a 4 x 4 block of bytes as four 32-bit rows
// (a warp's reads: 64 contiguous bytes of two rows), transposes it in
// registers (byte permutes) and writes its four columns as words of the
// destination's rows into shared memory (rows padded to 17 words); then
// each thread writes 16 contiguous bytes of a destination row. rows a
// multiple of 64, cols of 16 (a 4-byte group of columns is all in or out).
constexpr int kTT = 64;

__global__ void __launch_bounds__(256) transpose_i8_kernel(const int8_t* __restrict__ src,
                                                           int8_t* __restrict__ dst, int rows,
                                                           int cols) {
  __shared__ uint32_t tile[kTT][kTT / 4 + 1];  // [dst row][4 dst columns]
  const int c0 = blockIdx.x * kTT, r0 = blockIdx.y * kTT;
  const int bm = threadIdx.x % 16, bk = threadIdx.x / 16;
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (c0 + 4 * bm < cols) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *reinterpret_cast<const uint32_t*>(src + static_cast<size_t>(r0 + 4 * bk + i) * cols +
                                                c0 + 4 * bm);
  }
  const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140), hi01 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140), hi23 = __byte_perm(v[2], v[3], 0x7362);
  tile[4 * bm][bk] = __byte_perm(lo01, lo23, 0x5410);  // byte 0 of the four rows
  tile[4 * bm + 1][bk] = __byte_perm(lo01, lo23, 0x7632);
  tile[4 * bm + 2][bk] = __byte_perm(hi01, hi23, 0x5410);
  tile[4 * bm + 3][bk] = __byte_perm(hi01, hi23, 0x7632);
  __syncthreads();
  const int rr = threadIdx.x / 4, q = threadIdx.x % 4;
  if (c0 + rr < cols) {
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(c0 + rr) * rows + r0 + 16 * q) =
        make_uint4(tile[rr][4 * q], tile[rr][4 * q + 1], tile[rr][4 * q + 2], tile[rr][4 * q + 3]);
  }
}

using ProbeKernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, int, int, int);

}  // namespace

// C entry point, bound from Python with ctypes. a: x [m, k] (trans_a 0) or,
// in bf16 only, xt [k, m] (trans_a 1); b: w [n, k]; out [m, n] int32 (bf16
// 0) or bf16 (bf16 1); all contiguous and 16-byte aligned. Needs k a
// multiple of 64, n of 128, m of 16 when trans_a, m >= 1. Encodes the
// tensor maps, launches on `stream` and returns the CUDA error (0 on
// success; a refused launch is an error).
extern "C" int vap_gemm_probe(const void* a, const void* b, void* out, int m, int n, int k,
                              int bf16_in, int trans_a, void* stream) {
  if (m < 1 || k < 64 || k % 64 || n < 128 || n % 128 || (trans_a && (m % 16 || !bf16_in)))
    return cudaErrorInvalidValue;
  const int elem = bf16_in ? 2 : 1;
  CUtensorMap map_a, map_b, map_out;
  cudaError_t err = trans_a ? sm90::make_map_rows(&map_a, a, k, m, elem, 64)
                            : sm90::make_map_rows(&map_a, a, m, k, elem, kBM);
  if (err == cudaSuccess) err = sm90::make_map_rows(&map_b, b, n, k, elem, kBN / kCluster);
  if (err == cudaSuccess) err = sm90::make_map_rows(&map_out, out, m, n, bf16_in ? 2 : 4, 64);
  if (err != cudaSuccess) return err;
  const ProbeKernel kernel = !bf16_in ? gemm_probe_i8_kernel
                             : trans_a ? gemm_probe_bf16_t_kernel
                                       : gemm_probe_bf16_kernel;
  return launch_persistent(kernel, ProbeRing::kSmem, m, n, kBN, static_cast<cudaStream_t>(stream),
                           map_a, map_b, map_out, m, n, k);
}

// C entry point: src [rows, cols] int8 -> dst [cols, rows] (K10's xt [K, M]
// -> x [M, K] before K9's int8 kernel); both contiguous, 16-byte aligned.
// Needs rows a multiple of 64 and cols of 16. Returns the launch's error.
extern "C" int vap_transpose_i8(const void* src, void* dst, int rows, int cols, void* stream) {
  if (rows < 64 || rows % 64 || cols < 16 || cols % 16 || rows / kTT > 65535)
    return cudaErrorInvalidValue;
  transpose_i8_kernel<<<dim3((cols + kTT - 1) / kTT, rows / kTT), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(static_cast<const int8_t*>(src),
                                                             static_cast<int8_t*>(dst), rows, cols);
  return cudaGetLastError();
}
