// K3: the W8A8 linear. y = (sum over K-chunks of (x_i8 w_i8^T)_c * s_x[:, c])
// * s_w + bias, in f32, written as bf16.
//
// Replaces the TPU kernel of vap_tpu/ops/int8_matmul.py `_w8a8_call`
// (`_w8a8_kernel`), and computes what it computes: per (row, chunk) of
// C = _pick(K, 1536) columns, amax = max(max|x|, 1e-8), x_i8 =
// rint(x * (127 / amax)) (the reciprocal divided once, then multiplied),
// s_x = amax * (1 / 127); each chunk's int32 partial is turned into f32
// (rounded to nearest, as the plain version's .float()), times its s_x, and
// added to an f32 sum in chunk order; the epilogue is acc * s_w + bias,
// rounded to bf16. The f32 steps use __fmul_rn / __fadd_rn, so no
// multiply-add is contracted and the output is bit-equal to the plain
// PyTorch version's.
//
// Design: two launches.
//   1. w8a8_quantize_kernel: one warp per (row, chunk) finds amax, writes
//      x_i8 [M, K] and s_x [M, K / C]. It stays a pass: a chunk's amax needs
//      all of its 1536 columns before any element is quantised (for 128
//      rows 384 KB of bf16, more than shared memory), and a producer that
//      quantised inside the GEMM would redo it for every N tile.
//   2. w8a8_gemm_sm90_kernel: the wgmma main loop of gemm_sm90.cuh (TMA
//      ring, a producer warp, two consumer warpgroups, 2-block clusters
//      sharing the w tile by multicast, a persistent grid, stores staged
//      through shared memory) at an output tile of 128 x 192 in four
//      stages of 40 KB, each consumer m64n192 int8 products into an int32
//      accumulator. At every chunk boundary (C / 128 stages) a consumer
//      waits for its products and folds the int32 partial into an f32
//      accumulator with each row's s_x (loaded when the chunk starts,
//      under its products); the next chunk's first product has scale_d = 0
//      (|partial| <= 127^2 * 1536 < 2^31). Both accumulators live in
//      registers: 96 + 96 a thread, which rules out the probe's 128 x 256
//      tile; 128 x 192 ran faster than 128 x 128 at every main-path shape
//      (PERF.md). s_w and the bias of a tile's columns wait in shared
//      memory for the epilogue.
// What bounds K3 on an H100: the int8 tensor-core rate, 2 * M * N * K
// operations at 1,979 TOP/s (0.339 ms at [35552, 3072] x [3072, 3072],
// 1.356 ms at K or N = 12288), above the bytes bound (0.133 / 0.337 ms).
// The quantise pass is bound by bytes: it reads x in bf16 and writes x_i8,
// 3 bytes an element.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "sm90.cuh"

namespace {

using namespace vap::gemm90;

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

constexpr int kBN = 192;  // output channels a tile
constexpr int kStages = 4;
// s_w and the bias of a tile's columns, a copy a consumer warpgroup
constexpr int kScaleBytes = 2 * kBN * 4;
using W8A8Ring = Ring<kBN, kStages, 2 * kScaleBytes>;

// The consumer: an int32 accumulator for the chunk, folded into f32.
struct W8A8Body {
  uint32_t acc[kBN / 2];
  float facc[kBN / 2];
  float s0, s1;               // s_x of this thread's two rows for the current chunk
  float col_sw[2], col_b[2];  // s_w and the bias of columns tid, tid + 128 of the tile
  float* scales;              // this warpgroup's [s_w | bias] of the tile's columns
  OutStage<kBN, 2> out;
  const float* sx;
  const float* sw;
  const float* bias;
  int m, n, nchunks, row;  // row: this thread's first row inside a tile

  // s_w and the bias of the tile's columns are loaded here and written to
  // shared memory after the first chunk, under its products (the previous
  // tile's epilogue has read them by then: its last box ends on the
  // warpgroup's barrier)
  __device__ __forceinline__ void begin(int n0) {
    const int tid = threadIdx.x % 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + 128 * i, col = n0 + c;
      const bool in = c < kBN && col < n;
      col_sw[i] = in ? sw[col] : 0.0f;
      col_b[i] = in && bias != nullptr ? bias[col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) facc[i] = 0.0f;
  }
  __device__ __forceinline__ void chunk_begin(int c, int m0) {
    const int r0 = m0 + row;
    s0 = r0 < m ? sx[static_cast<size_t>(r0) * nchunks + c] : 0.0f;
    s1 = r0 + 8 < m ? sx[static_cast<size_t>(r0 + 8) * nchunks + c] : 0.0f;
  }
  __device__ __forceinline__ void issue(uint32_t a, uint32_t b, bool first) {
    issue_stage(acc, a, b, first);
  }
  __device__ __forceinline__ void chunk_end(int c, int) {
    sm90::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const float p = __int2float_rn(static_cast<int>(acc[i]));
      facc[i] = __fadd_rn(facc[i], __fmul_rn(p, (i & 2) ? s1 : s0));
    }
    if (c == 0) {
      const int tid = threadIdx.x % 128;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (tid + 128 * i < kBN) {
          scales[tid + 128 * i] = col_sw[i];
          scales[kBN + tid + 128 * i] = col_b[i];
        }
      }
    }
  }
  // y = acc * s_w (+ bias), rounded to bf16, a box of 64 columns at a time
  __device__ __forceinline__ void store(int m0, int n0) {
    using O = decltype(out);
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int bx = 0; bx < O::kBoxes; ++bx) {
      out.begin_box();
      float2 s2[O::kBoxPairs], b2[O::kBoxPairs];
#pragma unroll
      for (int jj = 0; jj < O::kBoxPairs; ++jj) {
        const int c = 8 * (bx * O::kBoxPairs + jj) + 2 * t;
        s2[jj] = *reinterpret_cast<const float2*>(scales + c);
        b2[jj] = *reinterpret_cast<const float2*>(scales + kBN + c);
      }
#pragma unroll
      for (int jj = 0; jj < O::kBoxPairs; ++jj) {
        const int j = bx * O::kBoxPairs + jj;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float y0 = __fmul_rn(facc[4 * j + 2 * r], s2[jj].x);
          float y1 = __fmul_rn(facc[4 * j + 2 * r + 1], s2[jj].y);
          if (bias != nullptr) {
            y0 = __fadd_rn(y0, b2[jj].x);
            y1 = __fadd_rn(y1, b2[jj].y);
          }
          out.put(jj, r, sm90::pack_bf16x2(y0, y1));
        }
      }
      out.end_box(n0 + bx * O::kBoxCols, m0 + row / 64 * 64);
    }
  }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    w8a8_gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                          const __grid_constant__ CUtensorMap map_w,
                          const __grid_constant__ CUtensorMap map_out,
                          const float* __restrict__ sx, const float* __restrict__ sw,
                          const float* __restrict__ bias, int m, int n, int k, int chunk) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const W8A8Ring ring{base, smem};
  const TileWalk walk(m, n, kBN);
  const int nk = k / kBoxBytes;
  ring.init();
  if (threadIdx.x < 128) {  // the producer warpgroup
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      produce<kBN, kStages, 2 * kScaleBytes, 1, false>(ring, &map_x, &map_w, walk, nk);
    }
  } else {  // the two consumer warpgroups
    sm90::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;  // 128 w + 32 warp + 4 g + t
    const int w = tid / 128;
    W8A8Body body;
    body.scales = reinterpret_cast<float*>(smem + W8A8Ring::kAuxOffset + w * kScaleBytes);
    body.out = out_stage<2>(ring, w, &map_out);
    body.sx = sx;
    body.sw = sw;
    body.bias = bias;
    body.m = m;
    body.n = n;
    body.nchunks = k / chunk;
    body.row = w * 64 + (tid % 128) / 32 * 16 + (tid % 32) / 4;
    consume(ring, walk, k / chunk, chunk / kBoxBytes, body);
    body.out.finish();
  }
}

}  // namespace

// C entry point, bound from Python with ctypes. x [m, k] bf16, w [n, k]
// int8, sw [n] f32, bias [n] f32 or null; scratch xq [m, k] int8 and sx
// [m, k / chunk] f32; out [m, n] bf16; all contiguous and 16-byte aligned.
// Needs chunk a multiple of 128 dividing k, n a multiple of 128, m >= 1.
// Returns the CUDA error of the launches (0 on success; a refused launch is
// an error).
extern "C" int vap_w8a8(const void* x, const void* w, const void* sw, const void* bias,
                        void* xq, void* sx, void* out, int m, int n, int k, int chunk,
                        void* stream) {
  if (m < 1 || chunk < 128 || chunk % 128 || k % chunk || n < 128 || n % 128)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long items = (long long)m * (k / chunk);
  w8a8_quantize_kernel<<<static_cast<unsigned>((items + kQuantWarps - 1) / kQuantWarps),
                         kQuantWarps * 32, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<int8_t*>(xq),
                                                   static_cast<float*>(sx), m, k, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map_x, map_w, map_out;
  err = sm90::make_map_rows(&map_x, xq, m, k, 1, kBM);
  if (err == cudaSuccess) err = sm90::make_map_rows(&map_w, w, n, k, 1, kBN / kCluster);
  if (err == cudaSuccess) err = sm90::make_map_rows(&map_out, out, m, n, 2, 64);
  if (err != cudaSuccess) return err;
  return launch_persistent(w8a8_gemm_sm90_kernel, W8A8Ring::kSmem, m, n, kBN, s, map_x, map_w,
                           map_out, static_cast<const float*>(sx), static_cast<const float*>(sw),
                           static_cast<const float*>(bias), m, n, k, chunk);
}
