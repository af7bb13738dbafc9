// K5, and K7's and K8's backward in its form, at head_dim 64: the bf16
// flash-attention backward redesigned for Hopper on wgmma, TMA and warp
// specialisation.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_backward_t` (:1131; `_bwd_dq_kernel_t` :1065,
// `_bwd_dkv_kernel_t` :1091) at head_dim 64, the backward of CogVideoX's
// joint attention in training, and, given kv_lens, K7's backward there
// (`_fav_bwd` :1499). Entry `vap_flash_bwd_d64`; the contract is
// flash_bwd.cu's log2 form (not K6's row form): the gradient of out =
// softmax(q k^T * scale) v over [BH, S, 64], non-causal, keys past Skv
// masked, from the natural-log lse of the forward; delta = rowsum(out *
// dout) comes in f32 from the wrapper. Its rounding points:
//   s   = (q k^T in f32) * scale_log2 - lse * log2 e   (the unscaled bf16 q)
//   p   = 2^s
//   ds  = bf16(p (dout v^T - delta))    (enters both products)
//   dq  = scale * ds k
//   dk  = scale * ds^T q
//   dv  = bf16(p)^T dout
// A padded query row gets lse2 = +1e30, so its p is 0. K7: kv_lens [B]
// int32 (or null): sample b = bh / heads has keys [0, kv_lens[b]) only;
// every query row gets dq from those keys (0 for a sample with none), and
// dk and dv are exact zeros in the rows past the length.
//
// What bounds it on an H100: 10 * BH * Sq * Skv * 64 FLOP (five products)
// at 989 TFLOP/s against the bytes of q, k, v, out, dout, dq, dk, dv and
// lse: at CogVideoX's [1, 48, 35552, 64] 39.26 ms against 1.4 ms of memory.
// Two kernels without atomics compute S and dP twice, seven products, so
// this design cannot beat 7/5 of the bound (54.96 ms); each score also
// costs two exp2 on the MUFU unit (16 a clock an SM), 1/8 of a clock,
// under the 7/32 of its products. The mma.sync kernels this replaces
// (flash_bwd.cu's D = 64 instances) took 271.5 ms, SDPA's flash backward
// 143.3 ms.
//
// Design. Two kernels on one stream, no atomics, so every sum is made in
// one block in a fixed order and the gradients come out the same from run
// to run (the ring's rank-identical, owner-summed gradients rest on it).
// Each block is a producer warpgroup (setmaxnreg 40: one thread issues the
// TMA loads) and two consumer warpgroups (setmaxnreg 232):
//   dk/dv: one block per (bh, 128 keys); each consumer owns 64 keys, whose
//     K and V rows it keeps in registers as wgmma A operands for the whole
//     loop. Query tiles of 64 (q and dout by TMA, their lse * log2 e and
//     delta rows written by the producer's second warp, +1e30 and 0 past
//     Sq) come through a ring of kKvStages: S^T = K q^T and dP^T = V dout^T
//     (wgmma m64n64k16, A from registers, B K-major in shared memory), P^T
//     computed while dP^T is in flight, dv += bf16(P^T) dout issued while
//     dS^T is computed, then dk += bf16(dS^T) q (A from registers, B
//     MN-major);
//   dq: one block per (bh, 128 queries), each consumer's 64 q and dout rows
//     kept in registers as A operands; key tiles of kDqN (128) through a
//     ring of kDqStages: S = q K^T and dP = dout V^T (wgmma m64n128k16), P
//     while dP is in flight, dS, dq += bf16(dS) K (K MN-major).
// At D = 64 a row is one 128-byte swizzle box; the 3-D tensor maps
// [BH, S, 64] read zeros past S inside their own (b, h).
//
// Masks. The dq pass: a key at or past the length gets p = 0 and ds = 0 by
// a select; the tile holding the length is loaded whole, so between a K7
// length and Skv its K rows hold the caller's data (NaN in the tests), and
// the consumers zero them in shared memory before S and dS K read them (a
// NaN in V only reaches dP's own column, which the select drops). A tile
// wholly past the length is never loaded. The dk/dv pass: a key block
// wholly past the length writes its zero rows and returns; in the block
// that holds it, the rows past the length are computed from whatever they
// hold (a NaN stays in its own key's row) and stored as zeros by a select.
//
// K8's backward (`_fas_bwd` :1581, the same TPU kernels given segment ids)
// is the instance kSeg of both bodies (flash_bwd_sm90_d64_seg_dkv_kernel,
// flash_bwd_sm90_d64_seg_dq_kernel, entry `vap_flash_bwd_d64_seg`): q_seg
// [B, Sq] and kv_seg [B, Skv] int32 ids, padding -1. The entry builds the
// id range tables (sm90.cuh); warp 0 of a block finds the run of tiles that
// meets its own rows (the dq kernel: key tiles of its 128 queries; the dk/dv
// kernel: query tiles of its 128 keys), and every role walks that run only,
// the stage and barrier parity counting the tiles walked. Per tile, a
// consumer whose 64 rows and the tile hold one id, the same, takes K5's path
// unchanged; else each pair whose ids differ gets p = 0 and ds = 0 by a
// select (after the exponentials, before the products read them), the other
// side's ids read from global memory (-2 for a key past Skv, -3 for a query
// past Sq). So a cross-segment pair adds an exact 0 to dq, dk and dv; a key
// block with no query tile to walk writes dk = dv = 0, a query block with no
// key tile dq = 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int kRow = 128;  // bytes of a row: one swizzle box
constexpr int kThreads = 384;  // a producer and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse2 = 1e30f;  // lse2 of a padded query row: p = 2^(s - 1e30) = 0

// the dk/dv kernel: 128 keys a block, query tiles of kKvM through a ring
// of kKvStages (query tiles of 128 spill 208 bytes and ptxas serialises
// their wgmma for want of registers, warning C7512: 10% slower)
constexpr int kKvN = 128;
constexpr int kKvM = 64;
constexpr int kKvStages = 2;
constexpr int kKvKBytes = kKvN * kRow;  // the K (or V) tile
constexpr int kKvQBytes = kKvM * kRow;  // a q or dout tile
// per stage: q, dout; then the lse2 and delta rows of every stage
constexpr int kKvRowsOffset = 2 * kKvKBytes + 2 * kKvStages * kKvQBytes;
constexpr int kKvBarOffset = kKvRowsOffset + 2 * kKvStages * kKvM * 4;
constexpr int kKvBars = 1 + 2 * kKvStages;  // kv_full; full and empty per stage
constexpr int kKvSpanOffset = kKvBarOffset + 8 * kKvBars;  // K8: the block's run of query tiles
constexpr int kKvSmem = kKvSpanOffset + 16 + 1024;
// the dq kernel: 128 queries a block, key tiles of kDqN through a ring of
// kDqStages. With key tiles of 64 ptxas puts a tile's bf16 dS into the
// registers of dout's A operands, which the next tile's dP then reads
// (SASS), so dq is wrong past the first tile; fencing those operands
// around each product does not fix it (PERF.md)
constexpr int kDqM = 128;
constexpr int kDqN = 128;
constexpr int kDqStages = 2;
constexpr int kDqQBytes = kDqM * kRow;
constexpr int kDqKBytes = kDqN * kRow;
constexpr int kDqBarOffset = 2 * kDqQBytes + 2 * kDqStages * kDqKBytes;
constexpr int kDqBars = 1 + 3 * kDqStages;  // q_full; k_full, v_full, empty per stage
constexpr int kDqSpanOffset = kDqBarOffset + 8 * kDqBars;  // K8: the block's run of key tiles
constexpr int kDqSmem = kDqSpanOffset + 16 + 1024;

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int kc = 0; kc < N; ++kc) sm90::fence_regs(a[kc]);
}

// Round a [64, 8 N] accumulator (the warp's 16 rows) to bf16 A operands:
// chunks 2kc and 2kc + 1 -> k16 step kc.
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 2][4], const float (&c)[4 * N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j / 2][(j & 1) * 2] = sm90::pack_bf16x2(c[4 * j], c[4 * j + 1]);
    a[j / 2][(j & 1) * 2 + 1] = sm90::pack_bf16x2(c[4 * j + 2], c[4 * j + 3]);
  }
}

// d[64, N] = a[64, 64] . B[N rows, 64]^T: a as 4 k16 steps of A registers,
// B a K-major tile (one box) at shared address b.
template <int R>
__device__ __forceinline__ void scores(float (&d)[R], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sm90::wgmma_rs<0>(d, a[kk], sm90::desc_sw128(b + kk * 32, 16, 1024), kk > 0);
  }
}

// d[64, N] = A[64 rows, 64] . B[N rows, 64]^T, both K-major tiles (one box)
// at shared addresses a and b.
template <int R>
__device__ __forceinline__ void scores_ss(float (&d)[R], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sm90::wgmma_ss<0>(d, sm90::desc_sw128(a + kk * 32, 16, 1024),
                      sm90::desc_sw128(b + kk * 32, 16, 1024), kk > 0);
  }
}

// acc[64, 64] += a[64, 16 K] . B[16 K rows, 64]: a as K k16 steps of A
// registers, B an MN-major tile (one box) at shared address b.
template <int K>
__device__ __forceinline__ void accumulate(float (&acc)[32], const uint32_t (&a)[K][4],
                                           uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < K; ++kc) {
    sm90::wgmma_rs<1>(acc, a[kc], sm90::desc_sw128(b + kc * 16 * kRow, kRow * 64, 1024), 1);
  }
}

// Store a consumer warp's 16 rows [row0, row0 + 16) of acc * mul as bf16
// into the [rows, 64] matrix m: rows at or past `valid` as zeros (a
// select), rows at or past `rows` not at all.
__device__ __forceinline__ void store_rows(const float (&acc)[32], float mul, bf16* m, int row0,
                                           int valid, int rows) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    const bool keep = row < valid;
    bf16* out = m + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float lo = keep ? acc[4 * c + 2 * r] * mul : 0.0f;
      const float hi = keep ? acc[4 * c + 2 * r + 1] * mul : 0.0f;
      *reinterpret_cast<uint32_t*>(out + 8 * c + 2 * t) = sm90::pack_bf16x2(lo, hi);
    }
  }
}

template <bool kSeg>
__device__ __forceinline__ void dkv_body(const CUtensorMap& map_q, const CUtensorMap& map_do,
                                         const CUtensorMap& map_k, const CUtensorMap& map_v,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, const int* __restrict__ kv_lens,
                                         const sm90::Segments seg, int heads, int sq, int skv,
                                         float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const uint32_t k_tile = base, v_tile = base + kKvKBytes;
  auto stage_tile = [&](int s, int which) {  // which: 0 q, 1 dout
    return base + 2 * kKvKBytes + (2 * s + which) * kKvQBytes;
  };
  float* lse2_s = reinterpret_cast<float*>(smem + kKvRowsOffset);  // [stage][kKvM]
  float* dl_s = lse2_s + kKvStages * kKvM;
  const uint32_t bars = base + kKvBarOffset;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kKvStages + s); };

  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kKvN;
  const int len = vap::kv_length(kv_lens, bh, heads, skv);
  bf16* dk_b = dk + static_cast<size_t>(bh) * skv * D;
  bf16* dv_b = dv + static_cast<size_t>(bh) * skv * D;
  if (key0 >= len) {  // the whole block lies past the sample's keys: zero rows
    vap::zero_rows<D, kThreads>(dk_b, key0, min(key0 + kKvN, skv));
    vap::zero_rows<D, kThreads>(dv_b, key0, min(key0 + kKvN, skv));
    return;
  }
  int ntiles = (sq + kKvM - 1) / kKvM;
  int j0 = 0;  // the first query tile walked (K8)
  sm90::SegTable q_tab{}, kv_tab{};
  const int sample = bh / heads;
  int2& span_s = *reinterpret_cast<int2*>(smem + kKvSpanOffset);
  if constexpr (kSeg) {
    q_tab = seg.q_table(sample, sq);
    kv_tab = seg.kv_table(sample, skv);
    if (threadIdx.x < 32) {
      const int2 span = sm90::seg_span<kKvM>(q_tab, ntiles, kv_tab.range<kKvN>(key0));
      if (threadIdx.x == 0) span_s = span;
    }
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      sm90::mbar_init(full(s), 1 + 32);  // the TMA thread, and warp 1's rows
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if constexpr (kSeg) {
    j0 = span_s.x;
    ntiles = span_s.y - span_s.x;
  }

  if (threadIdx.x < 128) {  // the producer warpgroup
    sm90::reg_dealloc<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&map_q);
      sm90::tma_prefetch(&map_do);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * kKvKBytes);
      sm90::tma_load_3d(k_tile, &map_k, kv_full, 0, key0, bh);
      sm90::tma_load_3d(v_tile, &map_v, kv_full, 0, key0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kKvStages;
        sm90::mbar_wait(empty(s), ((j / kKvStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full(s), 2 * kKvQBytes);
        sm90::tma_load_3d(stage_tile(s, 0), &map_q, full(s), 0, (j0 + j) * kKvM, bh);
        sm90::tma_load_3d(stage_tile(s, 1), &map_do, full(s), 0, (j0 + j) * kKvM, bh);
      }
    } else if (warp == 1) {  // each tile's lse * log2 e and delta rows
      const float* lb = lse + static_cast<size_t>(bh) * sq;
      const float* db = delta + static_cast<size_t>(bh) * sq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kKvStages;
        sm90::mbar_wait(empty(s), ((j / kKvStages) & 1) ^ 1);
#pragma unroll
        for (int h = 0; h < kKvM / 32; ++h) {
          const int i = lane + 32 * h, row = (j0 + j) * kKvM + i;
          lse2_s[s * kKvM + i] = row < sq ? lb[row] * kLog2e : kPadLse2;
          dl_s[s * kKvM + i] = row < sq ? db[row] : 0.0f;
        }
        sm90::mbar_arrive(full(s));
      }
    }
  } else {  // the two consumer warpgroups, 64 keys each
    sm90::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int t = lane & 3;

    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    // K8: this warpgroup's keys' one id (or none) and the thread's two key
    // rows' ids; the queries' ids are read per tile where the pair is mixed
    int k_one = 0, kid[2] = {0, 0};
    const int* qs = nullptr;
    if constexpr (kSeg) {
      k_one = sm90::seg_single(kv_tab.range<64>(key0 + cw * 64));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = key0 + cw * 64 + warp * 16 + (lane >> 2) + 8 * r;
        kid[r] = row < skv ? __ldg(seg.kv_seg + static_cast<size_t>(sample) * skv + row) : -2;
      }
      qs = seg.q_seg + static_cast<size_t>(sample) * sq;
    }

    sm90::mbar_wait(kv_full, 0);
    // this warpgroup's K and V rows as A operands: in registers, or (K8) read
    // from shared memory by each product, as K6's are (kept in registers
    // beside the segmented form's state, ptxas gave wrong dk and dv)
    const uint32_t k_rows = k_tile + cw * 64 * kRow, v_rows = v_tile + cw * 64 * kRow;
    uint32_t ka[4][4], va[4][4];
    if constexpr (!kSeg) {
      sm90::load_a_sw128(ka, smem + (k_tile - base) + cw * 64 * kRow);
      sm90::load_a_sw128(va, smem + (v_tile - base) + cw * 64 * kRow);
    }

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kKvStages;
      const uint32_t q_s = stage_tile(s, 0), do_s = stage_tile(s, 1);
      // K8, decided before the tile's products are issued: whether the tile
      // pair is mixed, and then which of its pairs share an id
      bool pure = true;
      uint64_t keep = 0;
      if constexpr (kSeg) {
        const int m1 = (j0 + j) * kKvM;
        pure = sm90::seg_pure(k_one, q_tab.range<kKvM>(m1));
        if (!pure) {
          keep = sm90::seg_keep<kKvM>(kid, [&](int col) {
            return m1 + col < sq ? __ldg(qs + m1 + col) : -3;
          });
        }
      }
      sm90::mbar_wait(full(s), (j / kKvStages) & 1);

      // transposed scores: rows the warpgroup's keys, columns the tile's queries
      float st[kKvM / 2], dpt[kKvM / 2];
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      if constexpr (!kSeg) {
        fence_frags(ka);
        fence_frags(va);
      }
      sm90::wgmma_fence();
      if constexpr (kSeg) {
        scores_ss(st, k_rows, q_s);
        sm90::wgmma_commit();
        scores_ss(dpt, v_rows, do_s);
      } else {
        scores(st, ka, q_s);
        sm90::wgmma_commit();
        scores(dpt, va, do_s);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S^T done; dP^T may still run
      sm90::fence_regs(st);

      const float* l2 = lse2_s + s * kKvM;
      const float* dl = dl_s + s * kKvM;
#pragma unroll
      for (int i = 0; i < kKvM / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);
        st[i] = sm90::ex2(fmaf(st[i], scale_log2, -l2[col]));  // p^T
      }
      if (!pure) {  // K8: a mixed tile pair's cross-segment p^T (and below ds^T) to 0
#pragma unroll
        for (int i = 0; i < kKvM / 2; ++i) st[i] = (keep >> i) & 1 ? st[i] : 0.0f;
      }
      uint32_t pa[kKvM / 16][4], dsa[kKvM / 16][4];
      to_frags<kKvM / 8>(pa, st);
      fence_frags(pa);
      sm90::fence_regs(dv_acc);
      sm90::wgmma_fence();
      accumulate(dv_acc, pa, do_s);  // dv += p^T dout
      sm90::wgmma_commit();

      sm90::wgmma_wait<1>();  // dP^T done; dv may still run
      sm90::fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < kKvM / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);
        dpt[i] = st[i] * (dpt[i] - dl[col]);  // ds^T, in place of dp^T
      }
      if (!pure) {
#pragma unroll
        for (int i = 0; i < kKvM / 2; ++i) dpt[i] = (keep >> i) & 1 ? dpt[i] : 0.0f;
      }
      to_frags<kKvM / 8>(dsa, dpt);
      fence_frags(dsa);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
      accumulate(dk_acc, dsa, q_s);  // dk += ds^T q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      if constexpr (!kSeg) {
        fence_frags(ka);
        fence_frags(va);
      }
      fence_frags(pa);
      fence_frags(dsa);
      sm90::mbar_arrive(empty(s));
    }
    const int row0 = key0 + cw * 64 + warp * 16;
    store_rows(dk_acc, scale, dk_b, row0, len, skv);
    store_rows(dv_acc, 1.0f, dv_b, row0, len, skv);
  }
}

template <bool kSeg>
__device__ __forceinline__ void dq_body(const CUtensorMap& map_q, const CUtensorMap& map_do,
                                        const CUtensorMap& map_k, const CUtensorMap& map_v,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, bf16* __restrict__ dq,
                                        const int* __restrict__ kv_lens, const sm90::Segments seg,
                                        int heads, int sq, int skv, float scale_log2,
                                        float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const uint32_t q_tile = base, do_tile = base + kDqQBytes;
  auto k_tile = [&](int s) { return base + 2 * kDqQBytes + s * kDqKBytes; };
  auto v_tile = [&](int s) {
    return base + 2 * kDqQBytes + (kDqStages + s) * kDqKBytes;
  };
  const uint32_t bars = base + kDqBarOffset;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kDqStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kDqStages + s); };

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kDqM;
  const int len = vap::kv_length(kv_lens, bh, heads, skv);
  int ntiles = (len + kDqN - 1) / kDqN;
  int j0 = 0;  // the first key tile walked (K8)
  sm90::SegTable q_tab{}, kv_tab{};
  const int sample = bh / heads;
  int2& span_s = *reinterpret_cast<int2*>(smem + kDqSpanOffset);
  if constexpr (kSeg) {
    q_tab = seg.q_table(sample, sq);
    kv_tab = seg.kv_table(sample, skv);
    if (threadIdx.x < 32) {
      const int2 span = sm90::seg_span<kDqN>(kv_tab, ntiles, q_tab.range<kDqM>(m0));
      if (threadIdx.x == 0) span_s = span;
    }
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if constexpr (kSeg) {
    j0 = span_s.x;
    ntiles = span_s.y - span_s.x;
  }

  if (threadIdx.x < 128) {  // the producer warpgroup
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&map_k);
      sm90::tma_prefetch(&map_v);
      sm90::mbar_arrive_expect_tx(q_full, 2 * kDqQBytes);
      sm90::tma_load_3d(q_tile, &map_q, q_full, 0, m0, bh);
      sm90::tma_load_3d(do_tile, &map_do, q_full, 0, m0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kDqStages;
        sm90::mbar_wait(empty(s), ((j / kDqStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(k_full(s), kDqKBytes);
        sm90::tma_load_3d(k_tile(s), &map_k, k_full(s), 0, (j0 + j) * kDqN, bh);
        sm90::mbar_arrive_expect_tx(v_full(s), kDqKBytes);
        sm90::tma_load_3d(v_tile(s), &map_v, v_full(s), 0, (j0 + j) * kDqN, bh);
      }
    }
  } else {  // the two consumer warpgroups, 64 query rows each
    sm90::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = m0 + cw * 64 + warp * 16;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      const size_t at = static_cast<size_t>(bh) * sq + row;
      lse2[r] = row < sq ? lse[at] * kLog2e : kPadLse2;
      dl[r] = row < sq ? delta[at] : 0.0f;
    }

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

    // K8: this warpgroup's rows' one id (or none) and the thread's two rows'
    // ids; the keys' ids are read per tile where the pair is mixed
    int q_one = 0, qid[2] = {0, 0};
    const int* kvs = nullptr;
    if constexpr (kSeg) {
      q_one = sm90::seg_single(q_tab.range<64>(m0 + cw * 64));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        qid[r] = row < sq ? __ldg(seg.q_seg + static_cast<size_t>(sample) * sq + row) : -3;
      }
      kvs = seg.kv_seg + static_cast<size_t>(sample) * skv;
    }

    sm90::mbar_wait(q_full, 0);
    uint32_t qa[4][4], da[4][4];  // this warpgroup's q and dout rows as A operands
    sm90::load_a_sw128(qa, smem + (q_tile - base) + cw * 64 * kRow);
    sm90::load_a_sw128(da, smem + (do_tile - base) + cw * 64 * kRow);

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kDqStages;
      const uint32_t parity = (j / kDqStages) & 1;
      const int valid = len - (j0 + j) * kDqN;  // keys of this tile below the length (>= 1)
      // K8, decided before the tile's products are issued: whether the tile
      // pair is mixed, and then which of its pairs share an id
      bool pure = true;
      uint64_t keep = 0;
      if constexpr (kSeg) {
        const int k0 = (j0 + j) * kDqN;
        pure = sm90::seg_pure(q_one, kv_tab.range<kDqN>(k0));
        if (!pure) {
          keep = sm90::seg_keep<kDqN>(
              qid, [&](int col) { return col < valid ? __ldg(kvs + k0 + col) : -2; });
        }
      }

      sm90::mbar_wait(k_full(s), parity);
      if (len < skv && valid < kDqN) {
        // K7: K rows between the length and Skv hold the caller's data
        // (NaN in the tests); zero them before S and dS K read them
        sm90::zero_rows(smem + (k_tile(s) - base), 1, kDqKBytes, valid,
                        min(kDqN, skv - j * kDqN), tid, kConsumers, 1);
      }

      sm90::mbar_wait(v_full(s), parity);
      float sc[kDqN / 2], dp[kDqN / 2];
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      fence_frags(qa);
      fence_frags(da);
      sm90::wgmma_fence();
      scores(sc, qa, k_tile(s));
      sm90::wgmma_commit();
      scores(dp, da, v_tile(s));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // S done; dP may still run
      sm90::fence_regs(sc);

      // p in place of s, then ds; keys at or past the length (only in the
      // last tile) give 0 by a select
      if (valid < kDqN) {
#pragma unroll
        for (int i = 0; i < kDqN / 2; ++i) {
          const int col = 8 * (i / 4) + 2 * t + (i & 1);
          const float p = sm90::ex2(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]));
          sc[i] = col < valid ? p : 0.0f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kDqN / 2; ++i) {
          sc[i] = sm90::ex2(fmaf(sc[i], scale_log2, -lse2[(i >> 1) & 1]));
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      fence_frags(qa);
      fence_frags(da);
      if (valid < kDqN) {
#pragma unroll
        for (int i = 0; i < kDqN / 2; ++i) {
          const int col = 8 * (i / 4) + 2 * t + (i & 1);
          sc[i] = col < valid ? sc[i] * (dp[i] - dl[(i >> 1) & 1]) : 0.0f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kDqN / 2; ++i) sc[i] *= dp[i] - dl[(i >> 1) & 1];
      }
      if (!pure) {  // K8: a mixed tile pair's cross-segment ds selected to 0
#pragma unroll
        for (int i = 0; i < kDqN / 2; ++i) sc[i] = (keep >> i) & 1 ? sc[i] : 0.0f;
      }
      uint32_t dsa[kDqN / 16][4];
      to_frags<kDqN / 8>(dsa, sc);

      fence_frags(dsa);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      accumulate(acc, dsa, k_tile(s));  // dq += ds K
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      fence_frags(dsa);
      sm90::mbar_arrive(empty(s));
    }
    store_rows(acc, scale, dq + static_cast<size_t>(bh) * sq * D, row0, sq, sq);
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_d64_dkv_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const int* __restrict__ kv_lens, int heads, int sq, int skv,
    float scale_log2, float scale) {
  dkv_body<false>(map_q, map_do, map_k, map_v, lse, delta, dk, dv, kv_lens, sm90::Segments{},
                  heads, sq, skv, scale_log2, scale);
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_d64_dq_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    const int* __restrict__ kv_lens, int heads, int sq, int skv, float scale_log2, float scale) {
  dq_body<false>(map_q, map_do, map_k, map_v, lse, delta, dq, kv_lens, sm90::Segments{}, heads,
                 sq, skv, scale_log2, scale);
}

// K8's backward (kSeg): no kv_lens, every key below Skv.
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_d64_seg_dkv_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, const sm90::Segments seg, int heads, int sq, int skv, float scale_log2,
    float scale) {
  dkv_body<true>(map_q, map_do, map_k, map_v, lse, delta, dk, dv, nullptr, seg, heads, sq, skv,
                 scale_log2, scale);
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_d64_seg_dq_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    const sm90::Segments seg, int heads, int sq, int skv, float scale_log2, float scale) {
  dq_body<true>(map_q, map_do, map_k, map_v, lse, delta, dq, nullptr, seg, heads, sq, skv,
                scale_log2, scale);
}

// The tensor maps of both kernels: the dk/dv kernel's q, dout, k, v, then
// the dq kernel's.
struct Maps {
  CUtensorMap kv_q, kv_do, kv_k, kv_v, dq_q, dq_do, dq_k, dq_v;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                      int bh, int sq, int skv) {
  // no key at all: the key maps are never read; q stands in for k and v
  const void* kp = skv ? k : q;
  const void* vp = skv ? v : q;
  const int krows = skv ? skv : sq;
  cudaError_t err = sm90::make_map(&m->kv_q, q, bh, sq, D, kKvM);
  if (err == cudaSuccess) err = sm90::make_map(&m->kv_do, dout, bh, sq, D, kKvM);
  if (err == cudaSuccess) err = sm90::make_map(&m->kv_k, kp, bh, krows, D, kKvN);
  if (err == cudaSuccess) err = sm90::make_map(&m->kv_v, vp, bh, krows, D, kKvN);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_q, q, bh, sq, D, kDqM);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_do, dout, bh, sq, D, kDqM);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_k, kp, bh, krows, D, kDqN);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_v, vp, bh, krows, D, kDqN);
  return err;
}

}  // namespace

// C entry point, bound from Python with ctypes: K5, and K7's backward at
// head_dim 64. q, k, v, dout, dq, dk, dv contiguous [bh, s, 64] bf16 (q,
// dout, dq: sq rows; k, v, dk, dv: skv rows), 16-byte aligned; lse and
// delta [bh, sq] f32; kv_lens a device pointer to [bh / heads] int32 valid
// key counts (K7) or null; scale_log2 = softmax scale * log2(e), `scale`
// the softmax scale. Encodes the tensor maps on the host, then launches on
// `stream` the dk/dv kernel and the dq kernel, and returns the CUDA error
// of the launches (0 on success). bh <= 65535, sq >= 1, heads >= 1 divides
// bh.
extern "C" int vap_flash_bwd_d64(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                 const void* kv_lens, int bh, int heads, int sq, int skv,
                                 float scale_log2, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, bh, sq, skv);
  if (err != cudaSuccess) return err;

  if (skv > 0) {  // no key row: dk and dv are empty
    err = cudaFuncSetAttribute(flash_bwd_sm90_d64_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_sm90_d64_dkv_kernel<<<dim3((skv + kKvN - 1) / kKvN, bh), kThreads,
                                    kKvSmem, st>>>(
        m.kv_q, m.kv_do, m.kv_k, m.kv_v, l, de, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        lens, heads, sq, skv, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(flash_bwd_sm90_d64_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_d64_dq_kernel<<<dim3((sq + kDqM - 1) / kDqM, bh), kThreads,
                                 kDqSmem, st>>>(m.dq_q, m.dq_do, m.dq_k, m.dq_v, l, de,
                                                static_cast<bf16*>(dq), lens, heads, sq, skv,
                                                scale_log2, scale);
  return cudaGetLastError();
}

// C entry point of K8's backward at head_dim 64: the tensors as above;
// q_seg [bh / heads, sq] and kv_seg [bh / heads, skv] int32 segment ids
// (padding -1); ranges a device scratch of (bh / heads) * (ceil(sq / 64) +
// ceil(skv / 64)) int2, which the entry fills (sm90::seg_tables) before the
// kernels read it. Launches the range tables, the dk/dv kernel and the dq
// kernel, and returns the CUDA error of the launches.
extern "C" int vap_flash_bwd_d64_seg(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, const void* q_seg,
                                     const void* kv_seg, void* ranges, int bh, int heads, int sq,
                                     int skv, float scale_log2, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  Maps m;
  sm90::Segments seg;
  cudaError_t err = make_maps(&m, q, k, v, dout, bh, sq, skv);
  if (err == cudaSuccess) {
    err = sm90::seg_tables(&seg, q_seg, kv_seg, ranges, bh / heads, sq, skv, st);
  }
  if (err != cudaSuccess) return err;
  if (skv > 0) {  // no key row: dk and dv are empty
    err = cudaFuncSetAttribute(flash_bwd_sm90_d64_seg_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_sm90_d64_seg_dkv_kernel<<<dim3((skv + kKvN - 1) / kKvN, bh), kThreads, kKvSmem,
                                        st>>>(m.kv_q, m.kv_do, m.kv_k, m.kv_v, l, de,
                                              static_cast<bf16*>(dk), static_cast<bf16*>(dv), seg,
                                              heads, sq, skv, scale_log2, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(flash_bwd_sm90_d64_seg_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_d64_seg_dq_kernel<<<dim3((sq + kDqM - 1) / kDqM, bh), kThreads, kDqSmem, st>>>(
      m.dq_q, m.dq_do, m.dq_k, m.dq_v, l, de, static_cast<bf16*>(dq), seg, heads, sq, skv,
      scale_log2, scale);
  return cudaGetLastError();
}

// The (query block rows, key tile rows) of the K8 dq kernel above and the
// (key block rows, query tile rows) of its dk/dv kernel, the sizes their
// tile rule counts in; SEGMENT_TILES in ops/flash_attention.py repeats them
// for the CPU and is held against this on the card.
extern "C" int vap_flash_bwd_d64_seg_tiles(int* tiles) {
  tiles[0] = kDqM;
  tiles[1] = kDqN;
  tiles[2] = kKvN;
  tiles[3] = kKvM;
  return 0;
}
