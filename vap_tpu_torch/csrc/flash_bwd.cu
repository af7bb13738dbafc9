// K5: bf16 flash-attention backward at head_dim < 128 except 64, and K8's
// backward at the same head dims. K5 at head_dim 64, the main path's
// (CogVideoX training), and K7's and K8's backward there moved to the wgmma
// kernels of flash_bwd_sm90_d64.cu (entries `vap_flash_bwd_d64`,
// `vap_flash_bwd_d64_seg`): both entries here refuse d = 64, which no
// instance here takes.
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
// K7's backward at head_dim < 128 (`_fav_bwd` :1499 through
// `_flash_attention_backward_t(kv_lens=)`, whose per-(b,h) bias column
// :1188-1192 sends p of an invalid key to 0) is this kernel given kv_lens
// [B] int32, in the same log2 form: sample b = bh / heads has keys
// [0, kv_lens[b]) only, clamped to [0, Skv]. Only keys are masked; every
// query row gets its dq from its sample's valid keys. The dq kernel's key
// loop stops at the length (no key past it is loaded; a sample with no key
// gets dq = 0); the dk/dv kernel loads only valid K and V rows, stores
// zeros for the rows past the length, and a tile that lies wholly past it
// writes its zero rows and returns (dk and dv come from torch.empty).
// kv_lens == nullptr is the fixed-length path, a separate instance of each
// kernel (kVarlen = false) compiled as it was before kv_lens: with the
// length known only at run time ptxas gave the D = 64 dk/dv kernel 187
// registers instead of 214 and K5 ran 12.8% slower on CogVideoX's shape.
//
// K8's backward at head_dim < 128 (`_fas_bwd` :1581 through
// `_flash_attention_backward_t(segment_ids=)`, whose one-hot contraction
// rows :1168-1176 send p of a cross-segment pair to 0) is the instance
// kSegmented = true, through its own kernels (`flash_bwd_seg_dq_kernel`,
// `flash_bwd_seg_dkv_kernel`) and entry (`vap_flash_bwd_seg`), so the
// instances above compile as they did: q_seg [B, Sq] and kv_seg [B, Skv]
// int32 ids, padding -1. The dq kernel keeps the ids of its thread's two
// query rows in registers and stages each key tile's 64 ids in shared
// memory beside K and V; the dk/dv kernel keeps its two key rows' ids in
// registers and stages each query tile's ids beside lse and delta. A pair
// whose ids differ gets p = 0 by a select, not a multiply, so it adds an
// exact 0 to dq, dk and dv: one segment's gradients are bit-identical
// whatever another segment holds (finite), and a query whose segment has
// no key gets dq = 0 (its lse is the forward's floor, -1e4, and no p
// reads it). Every tile is loaded and scored, as in K8's forward. The
// compare costs per score (a shared-memory load, a compare, a select): the
// first build, comparing every score, ran 35% slower than K5 at
// CogVideoX's shape. So each warp votes on its tile (`tile_pairs`): where
// its 16 rows and the staged tile hold one id it runs the fixed-length
// element loop, where the tile's one id is none of its rows' it sets p and
// ds to 0 without an exp2 (a cross-segment tile, half of them at two
// segments), and only a tile that mixes ids compares per score; the result
// is the same in the three.
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

// K8's pairs of a warp's tile (`tile_pairs`): all match, some, none.
constexpr int kAll = 1, kMixed = 0, kNone = -1;

// K8's dq step on a warp's [16, 64] tile: ds = p (dp - delta) in place of s,
// p = 0 for a key at or past `valid` and for a pair whose ids differ (a
// select: the pair adds an exact 0); kPairs says which pairs match.
template <int kPairs>
__device__ __forceinline__ void seg_dq_ds(float (&s)[kBlockN / 8][4], const float (&dp)[kBlockN / 8][4],
                                          int valid, const float (&lse2)[2], const float (&dl)[2],
                                          const int* seg_s, const int (&qid)[2], float scale_log2) {
  const int t = (threadIdx.x % 32) & 3;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      if constexpr (kPairs == kNone) {  // no pair of the tile matches: ds = 0
        s[j][e] = 0.0f;
        continue;
      }
      bool keep = col < valid;
      if constexpr (kPairs == kMixed) keep = keep && seg_s[col] == qid[e >> 1];
      const float p = keep ? exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) : 0.0f;
      s[j][e] = p * (dp[j][e] - dl[e >> 1]);
    }
  }
}

// K8's dk/dv step on a warp's transposed [16 keys, 64 queries] tile: p in
// place of s and ds^T in place of dp, p = 0 for a pair whose ids differ;
// kPairs says which pairs match.
template <int kPairs>
__device__ __forceinline__ void seg_dkv_p(float (&s)[kBlockM / 8][4], float (&dp)[kBlockM / 8][4],
                                          const float* lse2_s, const float* dl_s, const int* seg_s,
                                          const int (&kid)[2], float scale_log2) {
  const int t = (threadIdx.x % 32) & 3;
#pragma unroll
  for (int j = 0; j < kBlockM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      if constexpr (kPairs == kNone) {  // no pair of the tile matches: p = ds = 0
        dp[j][e] = s[j][e] = 0.0f;
        continue;
      }
      const bool keep = kPairs == kAll || seg_s[col] == kid[e >> 1];
      const float p = keep ? exp2f(fmaf(s[j][e], scale_log2, -lse2_s[col])) : 0.0f;
      dp[j][e] = p * (dp[j][e] - dl_s[col]);  // ds^T, in place of dp^T
      s[j][e] = p;
    }
  }
}

// Which pairs of a warp's tile match, the same on every lane: kAll when
// the staged tile's 64 ids (`tile`) are one value and so are the warp's
// rows' (`a0`, `a1` on each lane), kNone when the tile's one value is none
// of the rows', else kMixed; the first two need no per-score compare.
__device__ __forceinline__ int tile_pairs(const int* tile, int a0, int a1) {
  const int lane = threadIdx.x % 32;
  const int id = tile[0];
  if (!__all_sync(0xffffffffu, tile[lane] == id && tile[lane + 32] == id)) return kMixed;
  if (__all_sync(0xffffffffu, a0 == id && a1 == id)) return kAll;
  return __all_sync(0xffffffffu, a0 != id && a1 != id) ? kNone : kMixed;
}

// Store a warp's 16 rows of acc * mul as bf16: rows at or past `valid` as
// zeros, rows at or past `rows` skipped.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, __nv_bfloat16* m,
                                           int row0, int valid, int rows) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    const float mr = row < valid ? mul : 0.0f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(m + (size_t)row * D + i * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[i][2 * r] * mr, acc[i][2 * r + 1] * mr);
    }
  }
}

template <int D, bool kVarlen, bool kSegmented>
__device__ __forceinline__ void flash_bwd_dq_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    const int* __restrict__ kv_lens, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    int heads, int sq, int skv, float scale_log2, float scale) {
  constexpr int kStride = D + 8;  // bf16 elements per smem row; the pad spreads banks
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockN * kStride];
  __shared__ int seg_s[kSegmented ? kBlockN : 1];  // K8: the key tile's segment ids

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
  const int len = kVarlen ? vap::kv_length(kv_lens, bh, heads, skv) : skv;
  // K8: the ids of this thread's two query rows (rows past Sq are never
  // stored: any id serves them)
  int qid[2] = {0, 0};
  const int* kvs = nullptr;
  if constexpr (kSegmented) {
    const size_t b = bh / heads;
    qid[0] = row0 + g < sq ? q_seg[b * sq + row0 + g] : -1;
    qid[1] = row0 + g + 8 < sq ? q_seg[b * sq + row0 + g + 8] : -1;
    kvs = kv_seg + b * skv;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int n0 = 0; n0 < len; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    const int valid = min(kBlockN, len - n0);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(k_s), reinterpret_cast<const char*>(kb + (size_t)n0 * D), valid);
    vap::load_tile<kBlockN, D * 2, kStride * 2, kThreads>(
        reinterpret_cast<char*>(v_s), reinterpret_cast<const char*>(vb + (size_t)n0 * D), valid);
    if constexpr (kSegmented) {
      const int i = threadIdx.x;
      if (i < kBlockN) seg_s[i] = i < valid ? kvs[n0 + i] : -2;
    }
    __syncthreads();

    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
    mma_abt<D, kStride>(s, qa, k_s);
    mma_abt<D, kStride>(dp, da, v_s);
    if constexpr (kSegmented) {  // ds in place of s; the compare only where ids differ
      const int pairs = tile_pairs(seg_s, qid[0], qid[1]);
      if (pairs == kAll) {
        seg_dq_ds<kAll>(s, dp, valid, lse2, dl, seg_s, qid, scale_log2);
      } else if (pairs == kNone) {
        seg_dq_ds<kNone>(s, dp, valid, lse2, dl, seg_s, qid, scale_log2);
      } else {
        seg_dq_ds<kMixed>(s, dp, valid, lse2, dl, seg_s, qid, scale_log2);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const float p = col < valid ? exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1])) : 0.0f;
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);  // ds, in place of s
        }
      }
    }
    uint32_t dsa[kBlockN / 16][4];
    c_to_a(dsa, s);
    mma_ab<D, kStride>(acc, dsa, k_s);
  }
  store_rows<D>(acc, scale, dq + bh * sq * D, row0, sq, sq);
}

template <int D, bool kVarlen, bool kSegmented>
__device__ __forceinline__ void flash_bwd_dkv_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const int* __restrict__ kv_lens, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, int heads, int sq, int skv, float scale_log2, float scale) {
  constexpr int kStride = D + 8;
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 do_s[kBlockM * kStride];
  __shared__ float lse2_s[kBlockM];
  __shared__ float dl_s[kBlockM];
  __shared__ int seg_s[kSegmented ? kBlockM : 1];  // K8: the query tile's segment ids

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kBlockN + warp * 16;
  const int len = kVarlen ? vap::kv_length(kv_lens, bh, heads, skv) : skv;
  const int tile0 = blockIdx.x * kBlockN;
  if (kVarlen && tile0 >= len) {  // the whole tile lies past the sample's keys: zero rows
    vap::zero_rows<D, kThreads>(dk + bh * skv * D, tile0, min(tile0 + kBlockN, skv));
    vap::zero_rows<D, kThreads>(dv + bh * skv * D, tile0, min(tile0 + kBlockN, skv));
    return;
  }

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + bh * skv * D, key0, len);
  load_a<D>(va, v + bh * skv * D, key0, len);
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* db = dout + bh * sq * D;
  const float* lb = lse + bh * sq;
  const float* deb = delta + bh * sq;
  // K8: the ids of this thread's two key rows (rows past Skv are never
  // stored); a query row past Sq gets -3 in seg_s and matches none
  int kid[2] = {0, 0};
  const int* qsg = nullptr;
  if constexpr (kSegmented) {
    const size_t b = bh / heads;
    const int g = lane >> 2;
    kid[0] = key0 + g < skv ? kv_seg[b * skv + key0 + g] : -2;
    kid[1] = key0 + g + 8 < skv ? kv_seg[b * skv + key0 + g + 8] : -2;
    qsg = q_seg + b * sq;
  }

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
      if constexpr (kSegmented) seg_s[i] = i < valid ? qsg[m0 + i] : -3;
    }
    __syncthreads();

    // transposed scores: rows are the warp's keys, columns the tile's queries
    float s[kBlockM / 8][4], dp[kBlockM / 8][4];
    mma_abt<D, kStride>(s, ka, q_s);
    mma_abt<D, kStride>(dp, va, do_s);
    if constexpr (kSegmented) {  // the compare only where ids differ
      const int pairs = tile_pairs(seg_s, kid[0], kid[1]);
      if (pairs == kAll) {
        seg_dkv_p<kAll>(s, dp, lse2_s, dl_s, seg_s, kid, scale_log2);
      } else if (pairs == kNone) {
        seg_dkv_p<kNone>(s, dp, lse2_s, dl_s, seg_s, kid, scale_log2);
      } else {
        seg_dkv_p<kMixed>(s, dp, lse2_s, dl_s, seg_s, kid, scale_log2);
      }
    } else {
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
    }
    uint32_t pa[kBlockM / 16][4], dsa[kBlockM / 16][4];
    c_to_a(pa, s);
    c_to_a(dsa, dp);
    mma_ab<D, kStride>(dv_acc, pa, do_s);
    mma_ab<D, kStride>(dk_acc, dsa, q_s);
  }
  store_rows<D>(dk_acc, scale, dk + bh * skv * D, key0, len, skv);
  store_rows<D>(dv_acc, 1.0f, dv + bh * skv * D, key0, len, skv);
}

// K5 and K7's backward in K5's form (kSegmented = false).
template <int D, bool kVarlen>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    const int* __restrict__ kv_lens, int heads, int sq, int skv, float scale_log2, float scale) {
  flash_bwd_dq_body<D, kVarlen, false>(q, k, v, dout, lse, delta, dq, kv_lens, nullptr, nullptr,
                                       heads, sq, skv, scale_log2, scale);
}

template <int D, bool kVarlen>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const int* __restrict__ kv_lens, int heads, int sq, int skv,
    float scale_log2, float scale) {
  flash_bwd_dkv_body<D, kVarlen, false>(q, k, v, dout, lse, delta, dk, dv, kv_lens, nullptr,
                                        nullptr, heads, sq, skv, scale_log2, scale);
}

// K8's backward in K5's form: kernels of their own, so the instances above
// compile to what they were before segment ids.
// Three blocks an SM (at most 168 registers), as K5's dq kernel has: with
// the tile vote's three element loops ptxas otherwise gives it 196, two.
template <int D>
__global__ void __launch_bounds__(kThreads, 3) flash_bwd_seg_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int heads, int sq, int skv,
    float scale_log2, float scale) {
  flash_bwd_dq_body<D, false, true>(q, k, v, dout, lse, delta, dq, nullptr, q_seg, kv_seg, heads,
                                    sq, skv, scale_log2, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_seg_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    int heads, int sq, int skv, float scale_log2, float scale) {
  flash_bwd_dkv_body<D, false, true>(q, k, v, dout, lse, delta, dk, dv, nullptr, q_seg, kv_seg,
                                     heads, sq, skv, scale_log2, scale);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, void* dq, void* dk, void* dv, const int* kv_lens,
                   const int* q_seg, const int* kv_seg, int bh, int heads, int sq, int skv,
                   float scale_log2, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dp = static_cast<const bf*>(dout);
  bf* dqp = static_cast<bf*>(dq);
  bf* dkp = static_cast<bf*>(dk);
  bf* dvp = static_cast<bf*>(dv);
  const dim3 dq_grid((sq + kBlockM - 1) / kBlockM, bh), dkv_grid((skv + kBlockN - 1) / kBlockN, bh);
  if (q_seg != nullptr) {  // K8
    flash_bwd_seg_dq_kernel<D><<<dq_grid, kThreads, 0, stream>>>(
        qp, kp, vp, dp, lse, delta, dqp, q_seg, kv_seg, heads, sq, skv, scale_log2, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || skv == 0) return err;  // no key row: dk and dv are empty
    flash_bwd_seg_dkv_kernel<D><<<dkv_grid, kThreads, 0, stream>>>(
        qp, kp, vp, dp, lse, delta, dkp, dvp, q_seg, kv_seg, heads, sq, skv, scale_log2, scale);
    return cudaGetLastError();
  }
  // the varlen instance reads kv_lens; the fixed-length one is compiled as before kv_lens
  const auto dq_kernel = kv_lens ? flash_bwd_dq_kernel<D, true> : flash_bwd_dq_kernel<D, false>;
  dq_kernel<<<dq_grid, kThreads, 0, stream>>>(qp, kp, vp, dp, lse, delta, dqp, kv_lens, heads,
                                               sq, skv, scale_log2, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || skv == 0) return err;  // no key row: dk and dv are empty
  const auto dkv_kernel = kv_lens ? flash_bwd_dkv_kernel<D, true> : flash_bwd_dkv_kernel<D, false>;
  dkv_kernel<<<dkv_grid, kThreads, 0, stream>>>(qp, kp, vp, dp, lse, delta, dkp, dvp, kv_lens,
                                                 heads, sq, skv, scale_log2, scale);
  return cudaGetLastError();
}

// Head dims 16..112, step 16, but 64 (flash_bwd_sm90_d64.cu).
cudaError_t launch_d(int d, const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv,
                     const int* kv_lens, const int* q_seg, const int* kv_seg, int bh, int heads,
                     int sq, int skv, float scale_log2, float scale, cudaStream_t s) {
#define VAP_LAUNCH(D)                                                                          \
  case D:                                                                                      \
    return launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, kv_lens, q_seg, kv_seg, bh, heads, \
                     sq, skv, scale_log2, scale, s);
  switch (d) {
    VAP_LAUNCH(16)
    VAP_LAUNCH(32)
    VAP_LAUNCH(48)
    VAP_LAUNCH(80)
    VAP_LAUNCH(96)
    VAP_LAUNCH(112)
    default: return cudaErrorInvalidValue;
  }
#undef VAP_LAUNCH
}

}  // namespace

// C entry points, bound from Python with ctypes. Tensors are contiguous
// [bh, s, d] bf16 (q, dout, dq: sq rows; k, v, dk, dv: skv rows), lse and
// delta [bh, sq] f32; scale_log2 = softmax scale * log2(e). Each launches
// the dq kernel, then the dk/dv kernel, on `stream`, and returns the CUDA
// error of the launches (0 on success). bh <= 65535, sq >= 1, heads >= 1
// divides bh, head_dim d in 16..112, step 16, but 64 (vap_flash_bwd_d64,
// vap_flash_bwd_d64_seg).

// K5, and K7's backward: kv_lens is a device pointer to [bh / heads] int32
// valid key counts (K7) or null (every key valid).
extern "C" int vap_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, void* dk, void* dv,
                             const void* kv_lens, int bh, int heads, int sq, int skv, int d,
                             float scale_log2, float scale, void* stream) {
  return launch_d(d, q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, dk, dv, static_cast<const int*>(kv_lens),
                  nullptr, nullptr, bh, heads, sq, skv, scale_log2, scale,
                  static_cast<cudaStream_t>(stream));
}

// K8's backward: q_seg and kv_seg are device pointers to [bh / heads, sq]
// and [bh / heads, skv] int32 segment ids, padding as -1 (not null).
extern "C" int vap_flash_bwd_seg(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                 const void* q_seg, const void* kv_seg, int bh, int heads, int sq,
                                 int skv, int d, float scale_log2, float scale, void* stream) {
  if (q_seg == nullptr || kv_seg == nullptr) return cudaErrorInvalidValue;
  return launch_d(d, q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, dk, dv, nullptr,
                  static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), bh, heads, sq,
                  skv, scale_log2, scale, static_cast<cudaStream_t>(stream));
}
