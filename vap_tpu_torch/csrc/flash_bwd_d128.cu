// K6: bf16 flash-attention backward at head_dim 128, in the row layout.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_backward` (`_bwd_dq_kernel`, `_bwd_dkv_kernel`): the
// gradient of out = softmax(q k^T * scale) v over [BH, S, 128], non-causal,
// keys past Skv masked, from the natural-log lse that K4 saved; delta =
// rowsum(out * dout) comes in from the wrapper, f32. The arithmetic is the
// row-layout kernels', not K5's log2-domain one:
//   q_s = bf16(q * scale)              (rounded before q k^T)
//   p   = exp(q_s k^T - lse)           (natural base, natural-log lse)
//   ds  = p (dout v^T - delta)
//   dq  = scale * bf16(ds) k
//   dk  = scale * bf16(ds)^T q         (the unscaled q)
//   dv  = bf16(p)^T dout
// exp(x) is taken as exp2(x * log2(e)) against lse * log2(e).
//
// Design. Two kernels, as on the TPU, so that every sum is made in one
// block (no atomics) and comes out the same from run to run:
//   dq:  one block per (bh, 64-query tile), four warps of 16 query rows, a
//        loop over 64-key tiles; q_s and dout of the block are staged once
//        in shared memory, each K and V tile in turn.
//   dkv: one block per (bh, 64-key tile), four warps of 16 key rows, a loop
//        over 64-query tiles; K and V are staged once, each tile of q, q_s,
//        dout, lse and delta in turn. The scores are computed transposed
//        (s^T = k q_s^T, dp^T = v dout^T), so their C layout is the A layout
//        of dv += p^T dout and dk += ds^T q.
// Registers are what D = 128 makes scarce: the dk and dv accumulators of a
// warp's 16 keys are 128 floats a thread. So every A operand is read from
// shared memory (none stays in registers), and the dk/dv kernel holds the
// scores of 32 queries at a time (two halves of each staged tile): about
// 128 + 32 live floats, against K5's layout that would need ~290 here. The
// staged tiles take 68 KB (dq) and 85.5 KB (dk/dv) of dynamic shared
// memory, so two blocks fit on an SM. All five products run on the tensor
// cores as mma.sync m16n8k16 with f32 accumulation. A masked key gets p = 0
// in the dq kernel; a padded query row of the last tile is zero-filled with
// lse2 = +1e30, so its p is 0 and it adds nothing to dk and dv (the TPU's
// padded lse rows); key rows past Skv in the dk/dv kernel are computed and
// never stored.
//
// What bounds it on an H100: 10*B*H*Sq*Skv*D FLOP (five products) against
// about 2*(4*Sq + 4*Skv)*D bytes per (b,h); at Wan's self-attention
// [1, 40, 20280, 128] that is 21.3 ms of bf16 tensor-core time against
// 0.4 ms of memory traffic: compute bound. This first kernel is limited by
// mma.sync issue rate, the scalar shared-memory reads of the transposed B
// operands, the un-pipelined global->shared copies and the exp2 work per
// score; wgmma with TMA is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int kStride = D + 8;  // bf16 elements per smem row; the pad spreads banks
constexpr int kTile = 64;       // rows of every staged tile (queries or keys)
constexpr int kTileElems = kTile * kStride;
constexpr int kSub = 32;        // score columns a dk/dv warp holds at once
constexpr int kThreads = 128;   // four warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse2 = 1e30f;  // lse2 of a padded query row: p = exp2(s - 1e30) = 0
constexpr int kDqSmem = 4 * kTileElems * 2;                     // q_s, dout, k, v
constexpr int kDkvSmem = 5 * kTileElems * 2 + 2 * kTile * 4;    // k, v, q, q_s, dout; lse2, delta

__device__ __forceinline__ uint32_t u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of rows [row0, row0 + 16), columns [16c, 16c + 16) of a tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int row0, int c) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = tile + (row0 + g) * kStride + c * 16 + 2 * t;
  a[0] = u32(p);
  a[1] = u32(p + 8 * kStride);
  a[2] = u32(p + 8);
  a[3] = u32(p + 8 * kStride + 8);
}

// c[16, N] = A . B^T over D: A the rows [a_row0, a_row0 + 16) of a_s, B the
// rows [b_row0, b_row0 + N) of b_s (the n index, as K in q k^T).
template <int N>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], const bf16* a_s, int a_row0,
                                        const bf16* b_s, int b_row0) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll
  for (int cc = 0; cc < D / 16; ++cc) {
    uint32_t a[4];
    frag_a(a, a_s, a_row0, cc);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* br = b_s + (b_row0 + j * 8 + g) * kStride + cc * 16 + 2 * t;
      vap::mma_bf16_16816(c[j], a, u32(br), u32(br + 8));
    }
  }
}

// acc[16, D] += a[16, K] . B, a given as A fragments, B the rows
// [b_row0, b_row0 + K) of b_s (the k index, as K in ds k).
template <int K>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[K / 16][4],
                                       const bf16* b_s, int b_row0) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const bf16* br = b_s + (b_row0 + kc * 16 + 2 * t) * kStride + i * 8 + g;
      const uint32_t b0 = vap::pack_bf16(br[0], br[kStride]);
      const uint32_t b1 = vap::pack_bf16(br[8 * kStride], br[9 * kStride]);
      vap::mma_bf16_16816(acc[i], a[kc], b0, b1);
    }
  }
}

// Round a [16, N] C-layout tile to bf16 A fragments (n-tile j = 2kc (+1)
// fills regs 0,1 (2,3) of chunk kc).
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(c[j][0], c[j][1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(c[j][2], c[j][3]);
    a[j / 2][(j & 1) * 2 + 0] = *reinterpret_cast<const uint32_t*>(&lo);
    a[j / 2][(j & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
}

// A packed pair of bf16 (low element in the low bits) times `scale` in f32,
// each rounded back to bf16 to nearest even.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fmul_rn(lo, scale), __fmul_rn(hi, scale));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Stage kTile rows of a [rows, D] matrix (`valid` of them in range, the
// rest zero) as bf16(x * scale) into `scaled`, and as they are into `raw`
// unless it is null.
__device__ __forceinline__ void stage_scaled(bf16* raw, bf16* scaled, const bf16* src, int valid,
                                             float scale) {
  constexpr int kVecs = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    if (raw != nullptr) *reinterpret_cast<uint4*>(raw + r * kStride + c) = val;
    const uint4 out = make_uint4(scale_pair(val.x, scale), scale_pair(val.y, scale),
                                 scale_pair(val.z, scale), scale_pair(val.w, scale));
    *reinterpret_cast<uint4*>(scaled + r * kStride + c) = out;
  }
}

__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int valid) {
  vap::load_tile<kTile, D * 2, kStride * 2, kThreads>(reinterpret_cast<char*>(dst),
                                                     reinterpret_cast<const char*>(src), valid);
}

// Store a warp's 16 rows [row0, row0 + 16) of acc * mul as bf16 (rows at or
// past `rows` skipped).
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bf16* m,
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

__global__ void __launch_bounds__(kThreads) flash_bwd_d128_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int sq, int skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = qs_s + kTileElems;
  bf16* k_s = do_s + kTileElems;
  bf16* v_s = k_s + kTileElems;

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kTile;
  const int row0 = warp * 16;  // the warp's rows in the tile
  const int valid_q = min(kTile, sq - m0);

  stage_scaled(nullptr, qs_s, q + (bh * sq + m0) * D, valid_q, scale);
  stage(do_s, dout + (bh * sq + m0) * D, valid_q);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + row0 + g + 8 * r;
    lse2[r] = row < sq ? lse[bh * sq + row] * kLog2e : kPadLse2;
    dl[r] = row < sq ? delta[bh * sq + row] : 0.0f;
  }
  const bf16* kb = k + bh * skv * D;
  const bf16* vb = v + bh * skv * D;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int n0 = 0; n0 < skv; n0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile (and q_s, dout are staged)
    const int valid = min(kTile, skv - n0);
    stage(k_s, kb + (size_t)n0 * D, valid);
    stage(v_s, vb + (size_t)n0 * D, valid);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_abt<kTile>(s, qs_s, row0, k_s, 0);
    mma_abt<kTile>(dp, do_s, row0, v_s, 0);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float p = col < valid ? exp2f(fmaf(s[j][e], kLog2e, -lse2[e >> 1])) : 0.0f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // ds, in place of s
      }
    }
    uint32_t dsa[kTile / 16][4];
    c_to_a<kTile>(dsa, s);
    mma_ab<kTile>(acc, dsa, k_s, 0);
  }
  store_rows(acc, scale, dq + bh * sq * D, m0 + row0, sq);
}

__global__ void __launch_bounds__(kThreads) flash_bwd_d128_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTileElems;
  bf16* q_s = v_s + kTileElems;
  bf16* qs_s = q_s + kTileElems;
  bf16* do_s = qs_s + kTileElems;
  float* lse2_s = reinterpret_cast<float*>(do_s + kTileElems);
  float* dl_s = lse2_s + kTile;

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kTile;
  const int row0 = warp * 16;  // the warp's keys in the tile
  const int valid_k = min(kTile, skv - key0);

  stage(k_s, k + (bh * skv + key0) * D, valid_k);
  stage(v_s, v + (bh * skv + key0) * D, valid_k);
  const bf16* qb = q + bh * sq * D;
  const bf16* db = dout + bh * sq * D;
  const float* lb = lse + bh * sq;
  const float* deb = delta + bh * sq;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.0f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.0f;
  }

  for (int m0 = 0; m0 < sq; m0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile (and K, V are staged)
    const int valid = min(kTile, sq - m0);
    stage_scaled(q_s, qs_s, qb + (size_t)m0 * D, valid, scale);
    stage(do_s, db + (size_t)m0 * D, valid);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lse2_s[i] = i < valid ? lb[m0 + i] * kLog2e : kPadLse2;
      dl_s[i] = i < valid ? deb[m0 + i] : 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int h = 0; h < kTile; h += kSub) {
      // transposed scores: rows are the warp's keys, columns queries h..h+31
      float s[kSub / 8][4], dp[kSub / 8][4];
      mma_abt<kSub>(s, k_s, row0, qs_s, h);
      mma_abt<kSub>(dp, v_s, row0, do_s, h);
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h + j * 8 + 2 * t + (e & 1);
          const float p = exp2f(fmaf(s[j][e], kLog2e, -lse2_s[col]));
          dp[j][e] = p * (dp[j][e] - dl_s[col]);  // ds^T, in place of dp^T
          s[j][e] = p;
        }
      }
      uint32_t pa[kSub / 16][4], dsa[kSub / 16][4];
      c_to_a<kSub>(pa, s);
      c_to_a<kSub>(dsa, dp);
      mma_ab<kSub>(dv_acc, pa, do_s, h);
      mma_ab<kSub>(dk_acc, dsa, q_s, h);
    }
  }
  store_rows(dk_acc, scale, dk + bh * skv * D, key0 + row0, skv);
  store_rows(dv_acc, 1.0f, dv + bh * skv * D, key0 + row0, skv);
}

}  // namespace

// C entry point, bound from Python with ctypes. Tensors are contiguous
// [bh, s, 128] bf16 (q, dout, dq: sq rows; k, v, dk, dv: skv rows), lse
// and delta [bh, sq] f32; `scale` is the softmax scale. Launches the dq
// kernel, then the dk/dv kernel, on `stream`, and returns the CUDA error of
// the launches (0 on success). bh <= 65535, sq >= 1.
extern "C" int vap_flash_bwd_d128(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                  int bh, int sq, int skv, float scale, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_d128_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_d128_dq_kernel<<<dim3((sq + kTile - 1) / kTile, bh), kThreads, kDqSmem, s>>>(
      qp, kp, vp, dp, l, de, static_cast<bf16*>(dq), sq, skv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || skv == 0) return err;  // no key: dk and dv are empty
  err = cudaFuncSetAttribute(flash_bwd_d128_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_d128_dkv_kernel<<<dim3((skv + kTile - 1) / kTile, bh), kThreads, kDkvSmem, s>>>(
      qp, kp, vp, dp, l, de, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, skv, scale);
  return cudaGetLastError();
}
