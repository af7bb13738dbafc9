// K8's backward at head_dim 128: the bf16 flash-attention backward in the
// row layout, given packed-segment ids.
//
// Replaces, at head_dim 128, the TPU's `_fas_bwd` (vap_tpu/ops/
// flash_attention.py:1581; JAX sends segment ids to its transposed,
// log2-domain form at every head_dim, :1278-1283) with the arithmetic of
// the row-layout backward `_flash_attention_backward` (:1271;
// `_bwd_dq_kernel` :985, `_bwd_dkv_kernel` :1016), entry
// `vap_flash_bwd_seg_d128`: the gradient of out = softmax(q k^T * scale) v
// over [BH, S, 128], non-causal, from the natural-log lse of K8's forward;
// delta = rowsum(out * dout) comes in from the wrapper, f32:
//   q_s = bf16(q * scale)              (rounded before q k^T)
//   p   = exp(q_s k^T - lse)           (natural base, natural-log lse)
//   ds  = p (dout v^T - delta)
//   dq  = scale * bf16(ds) k
//   dk  = scale * bf16(ds)^T q         (the unscaled q)
//   dv  = bf16(p)^T dout
// exp(x) is taken as exp2(x * log2(e)) against lse * log2(e). It differs
// from JAX's by the rounding of q * scale, within the tests' tolerance. K6
// and K7's backward, the same arithmetic without segment ids, ran here too
// until they moved to the wgmma kernels of flash_bwd_sm90.cu (entry
// `vap_flash_bwd_d128`), the model for a later redesign of this one.
//
// Segments: q_seg [B, Sq] and kv_seg [B, Skv] int32 ids (padding -1). The
// dq kernel keeps its two query rows' ids in registers and stages each key
// tile's ids in shared memory, the dk/dv kernel keeps its two key rows' ids
// and stages each query tile's beside lse and delta. A pair whose ids differ
// gets p = 0 by a select, so it adds an exact 0 to dq, dk and dv (one
// segment's gradients are bit-identical whatever another holds), and a
// query whose segment has no key gets dq = 0. Each warp votes on its staged
// tile (`tile_pairs`), as in K5's form: one id over its rows and the tile
// runs the plain element loop, a tile whose one id is none of its rows'
// sets p and ds to 0 without an exp2, and only a tile that mixes ids
// compares per score (comparing every score cost the first build 28% at
// Wan's joint shape); the result is the same in the three.
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
// scores of 32 queries at a time (two halves of each staged tile). The
// staged tiles take 68 KB (dq) and 85.5 KB (dk/dv) of dynamic shared
// memory, plus 256 bytes of ids each, so two blocks fit on an SM. All five
// products run on the tensor cores as mma.sync m16n8k16 with f32
// accumulation. A key past Skv gets p = 0 in the dq kernel; a padded query
// row of the last tile is zero-filled with lse2 = +1e30, so its p is 0 and
// it adds nothing to dk and dv (the TPU's padded lse rows); key rows past
// Skv in the dk/dv kernel are computed and never stored.
//
// What bounds it on an H100: 10*H*D*sum_g |q_g|*|k_g| FLOP over the
// same-segment pairs against the bytes of the eight tensors; compute bound
// at the full-width cases. This kernel scores every pair; it is limited by
// mma.sync issue rate, the scalar shared-memory reads of the transposed B
// operands, the un-pipelined global->shared copies and the exp2 work per
// score.

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
constexpr int kSegSmem = kTile * 4;  // K8: one tile's int32 segment ids after the above

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

// K8's pairs of a warp's tile (`tile_pairs`): all match, some, none.
constexpr int kAll = 1, kMixed = 0, kNone = -1;

// K8's dq step on a warp's [16, kTile] tile: ds = p (dp - delta) in place of
// s, p = 0 for a key at or past `valid` and for a pair whose ids differ (a
// select: the pair adds an exact 0); kPairs says which pairs match.
template <int kPairs>
__device__ __forceinline__ void seg_dq_ds(float (&s)[kTile / 8][4], const float (&dp)[kTile / 8][4],
                                          int valid, const float (&lse2)[2], const float (&dl)[2],
                                          const int* seg_s, const int (&qid)[2]) {
  const int t = (threadIdx.x % 32) & 3;
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      if constexpr (kPairs == kNone) {  // no pair of the tile matches: ds = 0
        s[j][e] = 0.0f;
        continue;
      }
      bool keep = col < valid;
      if constexpr (kPairs == kMixed) keep = keep && seg_s[col] == qid[e >> 1];
      const float p = keep ? exp2f(fmaf(s[j][e], kLog2e, -lse2[e >> 1])) : 0.0f;
      s[j][e] = p * (dp[j][e] - dl[e >> 1]);
    }
  }
}

// K8's dk/dv step on a warp's transposed [16 keys, kSub queries] half tile
// from query h: p in place of s and ds^T in place of dp, p = 0 for a
// pair whose ids differ; kPairs says which pairs match.
template <int kPairs>
__device__ __forceinline__ void seg_dkv_p(float (&s)[kSub / 8][4], float (&dp)[kSub / 8][4], int h,
                                          const float* lse2_s, const float* dl_s, const int* seg_s,
                                          const int (&kid)[2]) {
  const int t = (threadIdx.x % 32) & 3;
#pragma unroll
  for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = h + j * 8 + 2 * t + (e & 1);
      if constexpr (kPairs == kNone) {  // no pair of the tile matches: p = ds = 0
        dp[j][e] = s[j][e] = 0.0f;
        continue;
      }
      const bool keep = kPairs == kAll || seg_s[col] == kid[e >> 1];
      const float p = keep ? exp2f(fmaf(s[j][e], kLog2e, -lse2_s[col])) : 0.0f;
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

// Store a warp's 16 rows [row0, row0 + 16) of acc * mul as bf16: rows at
// or past `valid` as zeros, rows at or past `rows` skipped.
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bf16* m,
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

// K8's backward in K6's row form: the dq kernel (see the note above).
// Three blocks an SM (at most 168 registers): with the tile vote's three
// element loops ptxas otherwise gives it 216, two.
__global__ void __launch_bounds__(kThreads, 3) flash_bwd_seg_d128_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
    int heads, int sq, int skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = qs_s + kTileElems;
  bf16* k_s = do_s + kTileElems;
  bf16* v_s = k_s + kTileElems;
  int* seg_s = reinterpret_cast<int*>(v_s + kTileElems);  // K8: the key tile's ids

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;
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
  // the ids of this thread's two query rows (rows past Sq are never stored)
  int qid[2];
  const size_t b = bh / heads;
  const int row = m0 + row0 + g;
  qid[0] = row < sq ? q_seg[b * sq + row] : -1;
  qid[1] = row + 8 < sq ? q_seg[b * sq + row + 8] : -1;
  const int* kvs = kv_seg + b * skv;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int n0 = 0; n0 < skv; n0 += kTile) {
    __syncthreads();  // every warp is done with the previous tile (and q_s, dout are staged)
    const int valid = min(kTile, skv - n0);
    stage(k_s, kb + (size_t)n0 * D, valid);
    stage(v_s, vb + (size_t)n0 * D, valid);
    const int i = threadIdx.x;
    if (i < kTile) seg_s[i] = i < valid ? kvs[n0 + i] : -2;
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_abt<kTile>(s, qs_s, row0, k_s, 0);
    mma_abt<kTile>(dp, do_s, row0, v_s, 0);
    // ds in place of s; the compare only where ids differ
    const int pairs = tile_pairs(seg_s, qid[0], qid[1]);
    if (pairs == kAll) {
      seg_dq_ds<kAll>(s, dp, valid, lse2, dl, seg_s, qid);
    } else if (pairs == kNone) {
      seg_dq_ds<kNone>(s, dp, valid, lse2, dl, seg_s, qid);
    } else {
      seg_dq_ds<kMixed>(s, dp, valid, lse2, dl, seg_s, qid);
    }
    uint32_t dsa[kTile / 16][4];
    c_to_a<kTile>(dsa, s);
    mma_ab<kTile>(acc, dsa, k_s, 0);
  }
  store_rows(acc, scale, dq + bh * sq * D, m0 + row0, sq, sq);
}

// K8's backward in K6's row form: the dk/dv kernel.
__global__ void __launch_bounds__(kThreads) flash_bwd_seg_d128_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, const int* __restrict__ q_seg,
    const int* __restrict__ kv_seg, int heads, int sq, int skv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kTileElems;
  bf16* q_s = v_s + kTileElems;
  bf16* qs_s = q_s + kTileElems;
  bf16* do_s = qs_s + kTileElems;
  float* lse2_s = reinterpret_cast<float*>(do_s + kTileElems);
  float* dl_s = lse2_s + kTile;
  int* seg_s = reinterpret_cast<int*>(dl_s + kTile);  // K8: the query tile's ids

  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key0 = blockIdx.x * kTile;
  const int row0 = warp * 16;  // the warp's keys in the tile
  const int valid_k = min(kTile, skv - key0);

  stage(k_s, k + (bh * skv + key0) * D, valid_k);
  stage(v_s, v + (bh * skv + key0) * D, valid_k);
  const bf16* qb = q + bh * sq * D;
  const bf16* db = dout + bh * sq * D;
  const float* lb = lse + bh * sq;
  const float* deb = delta + bh * sq;
  // the ids of this thread's two key rows (rows past Skv are never
  // stored); a query row past Sq gets -3 in seg_s and matches none
  int kid[2];
  const size_t b = bh / heads;
  const int key = key0 + row0 + (lane >> 2);
  kid[0] = key < skv ? kv_seg[b * skv + key] : -2;
  kid[1] = key + 8 < skv ? kv_seg[b * skv + key + 8] : -2;
  const int* qsg = q_seg + b * sq;

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
      seg_s[i] = i < valid ? qsg[m0 + i] : -3;
    }
    __syncthreads();
    const int pairs = tile_pairs(seg_s, kid[0], kid[1]);

#pragma unroll 1
    for (int h = 0; h < kTile; h += kSub) {
      // transposed scores: rows are the warp's keys, columns queries h..h+31
      float s[kSub / 8][4], dp[kSub / 8][4];
      mma_abt<kSub>(s, k_s, row0, qs_s, h);
      mma_abt<kSub>(dp, v_s, row0, do_s, h);
      if (pairs == kAll) {  // the compare only where ids differ
        seg_dkv_p<kAll>(s, dp, h, lse2_s, dl_s, seg_s, kid);
      } else if (pairs == kNone) {
        seg_dkv_p<kNone>(s, dp, h, lse2_s, dl_s, seg_s, kid);
      } else {
        seg_dkv_p<kMixed>(s, dp, h, lse2_s, dl_s, seg_s, kid);
      }
      uint32_t pa[kSub / 16][4], dsa[kSub / 16][4];
      c_to_a<kSub>(pa, s);
      c_to_a<kSub>(dsa, dp);
      mma_ab<kSub>(dv_acc, pa, do_s, h);
      mma_ab<kSub>(dk_acc, dsa, q_s, h);
    }
  }
  store_rows(dk_acc, scale, dk + bh * skv * D, key0 + row0, skv, skv);
  store_rows(dv_acc, 1.0f, dv + bh * skv * D, key0 + row0, skv, skv);
}

}  // namespace

// C entry point, bound from Python with ctypes. Tensors are contiguous
// [bh, s, 128] bf16 (q, dout, dq: sq rows; k, v, dk, dv: skv rows), lse
// and delta [bh, sq] f32; `scale` is the softmax scale; q_seg and kv_seg
// are device pointers to [bh / heads, sq] and [bh / heads, skv] int32
// segment ids, padding as -1 (not null). Launches the dq kernel, then the
// dk/dv kernel, on `stream`, and returns the CUDA error of the launches (0
// on success). bh <= 65535, sq >= 1, heads >= 1 divides bh.
extern "C" int vap_flash_bwd_seg_d128(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, const void* q_seg,
                                      const void* kv_seg, int bh, int heads, int sq, int skv,
                                      float scale, void* stream) {
  if (q_seg == nullptr || kv_seg == nullptr) return cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dp = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_seg_d128_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDqSmem + kSegSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_seg_d128_dq_kernel<<<dim3((sq + kTile - 1) / kTile, bh), kThreads,
                                 kDqSmem + kSegSmem, s>>>(
      qp, kp, vp, dp, l, de, static_cast<bf16*>(dq), qs, ks, heads, sq, skv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || skv == 0) return err;  // no key row: dk and dv are empty
  err = cudaFuncSetAttribute(flash_bwd_seg_d128_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem + kSegSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_seg_d128_dkv_kernel<<<dim3((skv + kTile - 1) / kTile, bh), kThreads,
                                  kDkvSmem + kSegSmem, s>>>(
      qp, kp, vp, dp, l, de, static_cast<bf16*>(dk), static_cast<bf16*>(dv), qs, ks, heads, sq,
      skv, scale);
  return cudaGetLastError();
}
