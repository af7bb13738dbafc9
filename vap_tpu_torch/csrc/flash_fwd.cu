// K1: bf16 flash-attention forward below head_dim 128 except 64, one kernel
// templated on head_dim, and K8's forward at the same head dims.
//
// K1 (head_dim < 128, a multiple of 16, entry `vap_flash_fwd`) replaces the
// TPU kernels of vap_tpu/ops/flash_attention.py `_flash_attention_forward_t`
// (`_fwd_kernel_t`, `_fwd_kernel_t_bound`). K4, the same function at head_dim
// 128 (`_flash_attention_forward`), ran here as the D = 128 instance until
// it moved to the wgmma kernel of flash_fwd_sm90.cu (entry
// `vap_flash_fwd_d128`). K1 at head_dim 64, the main path's (CogVideoX), and
// K7 there moved to the wgmma kernel of flash_fwd_sm90_d64.cu (entry
// `vap_flash_fwd_d64`), and K8 at 64 and 128 to the wgmma kernels' segmented
// instances (`vap_flash_fwd_d64_seg`, `vap_flash_fwd_d128_seg`): both
// entries here refuse d = 64, which no instance here takes. The
// TPU's kv-bias row that masks padded keys becomes the in-register mask of
// the ragged last tile. The contract: q [BH, Sq, D], k/v [BH, Skv, D] bf16
// -> out [BH, Sq, D] bf16 and the natural-log lse [BH, Sq] f32, non-causal,
// keys past Skv masked. It computes the running-max online softmax; the
// TPU's bound form is the same function with another reference point.
//
// K7, the varlen forward (`flash_attention_varlen`, the `varlen=True` form
// of the same TPU kernels and of `_fwd_kernel_t`), is this kernel given
// kv_lens [B] int32: sample b = bh / heads attends keys [0, kv_lens[b])
// only (suffix padding; queries are never masked). The key loop stops at
// that length and the last tile's mask takes it as its edge, so keys at or
// past it are never loaded and a NaN there cannot reach the output. As on
// the TPU (flash_attention.py:154-158), the running max starts at a floor of
// -1e4 nats: a sample with no valid key gets exact zero rows (l == 0) and
// the finite lse -1e4. kv_lens == nullptr is the fixed-length path.
//
// K8, the packed-segment forward (`flash_attention_segmented`, which the TPU
// runs through the same `_fwd_kernel_t` with `segment_ids`: the mask rides
// extra one-hot contraction dims, `_segment_onehot_ext`, at the cost of a
// second MXU depth pass at D >= 128), is the instance kSegmented = true:
// q_seg [B, Sq] and kv_seg [B, Skv] int32 ids, query i attends key j iff
// their ids are equal. The ids are compared in the kernel instead: each
// thread keeps the ids of its two query rows (g, g + 8) in registers, each
// key tile's 64 ids are staged in shared memory beside K and V, and a score
// whose ids differ is selected to kNegInf (a select, not a multiply, so a
// cross-segment key adds exactly 0 and never reaches the running max: one
// segment's outputs are bit-identical whatever another segment holds, as
// long as it is finite). The running max starts at the K7 floor, so a query
// whose segment has no key gets zero rows and the lse -1e4. The wrapper
// maps ids outside [0, num_segments) to -1 (padding); an in-range query
// never matches them. Every key tile is loaded and scored (the wgmma
// instances at 64 and 128 skip the tiles that share no id). The
// fixed-length and K7 instance (kSegmented = false) compiles to the code it
// had before.
//
// Design. One thread block per (bh, 64-query tile), four warps of 16 query
// rows; a loop over 64-key tiles inside the block takes the place of the
// TPU's sequential grid axis. Q stays in registers as mma A fragments; each
// kv tile is staged through shared memory; QK^T and PV run on the tensor
// cores as mma.sync m16n8k16 with f32 accumulation; the softmax stays in
// registers (the m16n8 C layout of S is reused as the A layout of P).
//
// What bounds it on an H100: attention does 4*S*D FLOP per query row
// against 4*D bytes of K/V per key, far above the card's ~295 FLOP/byte
// ridge, so it is compute bound; this kernel is limited by mma.sync issue
// rate, the un-pipelined global->shared copies (no cp.async/TMA) and the
// exp2 work per score. It runs at no model's head dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kThreads = 128;

template <int D, bool kSegmented>
__device__ __forceinline__ void flash_fwd_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ kv_lens, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, int heads, int sq, int skv, float scale_log2) {
  constexpr int kStride = D + 8;  // bf16 elements per smem row; the pad spreads banks
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];
  __shared__ int seg_s[kSegmented ? kBlockN : 1];  // K8: the key tile's segment ids

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
  const int len = vap::kv_length(kv_lens, bh, heads, skv);
  const float m0 = (kSegmented || kv_lens) ? vap::kVarlenFloorLog2 : vap::kNegInf;
  float m[2] = {m0, m0};
  float l[2] = {0.0f, 0.0f};
  // K8: the segment ids of this thread's two query rows (rows past Sq are
  // never stored, so any id serves them)
  int qid[2] = {0, 0};
  const int* kvs = nullptr;
  if constexpr (kSegmented) {
    const size_t b = bh / heads;
    const int* qs = q_seg + b * sq;
    qid[0] = row0 + g < sq ? qs[row0 + g] : -1;
    qid[1] = row0 + g + 8 < sq ? qs[row0 + g + 8] : -1;
    kvs = kv_seg + b * skv;
  }

  for (int n0 = 0; n0 < len; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    const int valid = min(kBlockN, len - n0);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(k_s), reinterpret_cast<const char*>(kb + (size_t)n0 * D), valid);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(v_s), reinterpret_cast<const char*>(vb + (size_t)n0 * D), valid);
    if constexpr (kSegmented) {
      const int i = threadIdx.x;
      if (i < kBlockN) seg_s[i] = i < valid ? kvs[n0 + i] : -1;
    }
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
        bool keep = col < valid;
        if constexpr (kSegmented) keep = keep && seg_s[col] == qid[e >> 1];
        s[j][e] = keep ? s[j][e] * scale_log2 : vap::kNegInf;
      }
    }
    vap::softmax_pv_tile<D, kBlockN, kStride>(s, m, l, acc, v_s);
  }
  vap::store_rows<D>(acc, m, l, o + bh * sq * D, lse + bh * sq, row0, sq);
}

// K1 and K7 (kSegmented = false), and K8 at the same head dims.
template <int D, bool kSegmented>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ kv_lens, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, int heads, int sq, int skv, float scale_log2) {
  flash_fwd_body<D, kSegmented>(q, k, v, o, lse, kv_lens, q_seg, kv_seg, heads, sq, skv,
                                scale_log2);
}

template <int D, bool kSegmented>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* kv_lens, const int* q_seg, const int* kv_seg, int bh, int heads,
                   int sq, int skv, float scale_log2, cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  flash_fwd_kernel<D, kSegmented><<<grid, kThreads, 0, stream>>>(
      qp, kp, vp, op, lse, kv_lens, q_seg, kv_seg, heads, sq, skv, scale_log2);
  return cudaGetLastError();
}

// Head dims of K1 (and of K7 and K8 in its form): 16..112, step 16, but 64
// (the wgmma kernels').
template <bool kSegmented>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                     const int* kv_lens, const int* q_seg, const int* kv_seg, int bh, int heads,
                     int sq, int skv, float scale_log2, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, kSegmented>(q, k, v, o, lse, kv_lens, q_seg, kv_seg, bh, heads,
                                            sq, skv, scale_log2, s);
    case 32: return launch<32, kSegmented>(q, k, v, o, lse, kv_lens, q_seg, kv_seg, bh, heads,
                                            sq, skv, scale_log2, s);
    case 48: return launch<48, kSegmented>(q, k, v, o, lse, kv_lens, q_seg, kv_seg, bh, heads,
                                            sq, skv, scale_log2, s);
    case 80: return launch<80, kSegmented>(q, k, v, o, lse, kv_lens, q_seg, kv_seg, bh, heads,
                                            sq, skv, scale_log2, s);
    case 96: return launch<96, kSegmented>(q, k, v, o, lse, kv_lens, q_seg, kv_seg, bh, heads,
                                            sq, skv, scale_log2, s);
    case 112: return launch<112, kSegmented>(q, k, v, o, lse, kv_lens, q_seg, kv_seg, bh, heads,
                                            sq, skv, scale_log2, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, bound from Python with ctypes. Tensors are contiguous
// [bh, s, d]; kv_lens is a device pointer to [bh / heads] int32 valid key
// counts (K7) or null (every key valid); q_seg and kv_seg are device
// pointers to [bh / heads, sq] and [bh / heads, skv] int32 segment ids (K8);
// scale_log2 = softmax scale * log2(e). Each returns the CUDA error of the
// launch (0 on success). bh <= 65535, sq >= 1, heads >= 1 divides bh.

// K1 (and K7 at these head dims): head_dim d in 16..112, step 16, but 64.
extern "C" int vap_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_lens, int bh, int heads, int sq, int skv, int d,
                             float scale_log2, void* stream) {
  return launch_d<false>(d, q, k, v, o, static_cast<float*>(lse),
                         static_cast<const int*>(kv_lens), nullptr, nullptr, bh, heads, sq, skv,
                         scale_log2, static_cast<cudaStream_t>(stream));
}

// K8 in K1's form: head_dim d in 16..112, step 16, but 64.
extern "C" int vap_flash_fwd_seg(const void* q, const void* k, const void* v, const void* q_seg,
                                 const void* kv_seg, void* o, void* lse, int bh, int heads, int sq,
                                 int skv, int d, float scale_log2, void* stream) {
  return launch_d<true>(d, q, k, v, o, static_cast<float*>(lse), nullptr,
                        static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), bh,
                        heads, sq, skv, scale_log2, static_cast<cudaStream_t>(stream));
}
