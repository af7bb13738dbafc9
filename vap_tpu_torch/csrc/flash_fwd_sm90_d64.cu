// K1, and K7's and K8's forms of it, at head_dim 64: the bf16
// flash-attention forward redesigned for Hopper on wgmma, TMA and warp
// specialisation.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_forward_t` (:479; `_fwd_kernel_t` :392,
// `_fwd_kernel_t_bound` :448) at head_dim 64, the forward of CogVideoX's
// joint attention, and, given kv_lens, K7's forward there
// (`flash_attention_varlen` :1471). Entry `vap_flash_fwd_d64`; the contract
// is flash_fwd.cu's: q [BH, Sq, 64], k and v [BH, Skv, 64] bf16 -> out
// [BH, Sq, 64] bf16 and the natural-log lse [BH, Sq] f32, non-causal, keys
// past Skv masked by a select, the running-max online softmax in the log2
// domain (scale_log2 = scale * log2 e from the wrapper), P rounded to bf16
// before P V and before its row sum. kv_lens [B] int32 (or null): sample
// b = bh / heads attends keys [0, kv_lens[b]) only; the running max then
// starts at the floor of -1e4 nats, so a sample with no key gets zero rows
// and the lse -1e4.
//
// What bounds it on an H100: 4 * BH * Sq * Skv * 64 FLOP at 989 TFLOP/s
// against the bytes of q, k, v, out and lse: at CogVideoX's [1, 48, 35552,
// 64] 15.70 ms of tensor-core time against 0.51 ms of memory. At D = 64 a
// score costs 256 FLOP, 1/16 of an SM's tensor-core clock, and one exp2,
// 1/16 of its MUFU clock (16 a clock): the exponentials take as long as
// the products, so a design that runs them one after the other can reach at
// most half the bound. The mma.sync kernel this replaces (flash_fwd.cu's
// D = 64 instance) ran at 16% of it (97.45 ms), SDPA's flash backend at
// 32% (48.90 ms), this kernel at 52% (about 30 ms on an H100 at 700 W;
// PERF.md).
//
// Design (FlashAttention-3's head_dim-64 forward). One block of four
// warpgroups per (bh, 192 queries):
//   producer (warpgroup 0, setmaxnreg 32): one thread issues the TMA loads,
//     the Q tile once, then K and V tiles of 128 keys into a ring of three
//     stages (a full barrier for K, one for V, an empty barrier that the
//     consumers release);
//   three consumers of 64 query rows each (setmaxnreg 160): S = Q K^T as 4
//     wgmma m64n128k16 from shared memory, the softmax in registers, and
//     O += P V as 8 wgmma m64n72k16 with P from registers and V read
//     MN-major, beside a box of bf16 ones: the accumulator's columns 64..71
//     are the row sum of the bf16 P, l, as the TPU kernels take it through
//     a ones row, with no per-score add in registers.
// The softmax was bound by instruction issue, not by the MUFU unit: taking
// a share of the exponentials onto the FMA pipe as a polynomial made it
// slower, while the row sum by the tensor cores made it 12% faster.
// The exponentials run under the tensor cores within each warpgroup: tile
// j's Q K^T and tile j - 1's P V are issued together, and the softmax of
// tile j runs while P V is in flight, its P kept in f32 until that product
// is waited for (then packed to bf16: writing P's registers under a product
// that reads them makes ptxas serialise every wgmma, warning C7513). Across
// the three warpgroups the warp schedulers overlap one's exponentials with
// another's wgmma without help: making the consumers take turns at the
// tensor cores on named barriers (FlashAttention-3's ping-pong) gained
// nothing measurable.
// D = 64 is one 128-byte swizzle box a row; tensors are 3-D tensor maps
// [BH, S, 64] in boxes [1, rows, 64], so a tile past S reads zeros inside
// its own (b, h). Shared memory: Q 24 KB, 3 stages of K and V 96 KB, the
// ones box 16 KB; one block an SM. PERF.md lists the variants measured
// (consumers, stages, the overlaps, the row sum).
//
// Masks. A key at or past the length (Skv, or kv_lens[b]) is selected to
// -1e30 in the raw scores (a select, never a multiply); only the last tile
// can hold one, and the loop stops at it. Between kv_lens[b] and Skv its V
// rows hold the caller's data (NaN in the tests): p is exactly 0 there, but
// 0 * NaN is NaN, so each consumer warpgroup zeroes those V rows in shared
// memory before its last P V (a proxy fence and a barrier of its own 128
// threads; the warpgroups write the same zeros, and no stage is refilled
// before every consumer has released it).
//
// K8, the packed-segment forward (`flash_attention_segmented` :1539, the
// same TPU kernel given segment ids), is the instance kSeg of the same body
// (flash_fwd_sm90_d64_seg_kernel, entry `vap_flash_fwd_d64_seg`): q_seg
// [B, Sq] and kv_seg [B, Skv] int32 ids, padding -1; query i attends key j
// iff their ids are equal. The entry first builds each side's table of id
// ranges (sm90.cuh, seg_ranges); warp 0 of each block finds the run of key
// tiles whose range meets its 192 rows' (seg_span), and producer and
// consumers walk that run only: the stage and the barrier parity count the
// tiles walked, so the pipeline is K1's. Each consumer decides per tile
// from its own 64 rows' range: where they and the key tile hold one id, the
// same, the tile takes K1's path unchanged; else each score whose ids
// differ is selected to -1e30 in the raw scores, where K1's mask runs (after
// the wait on Q K^T; the P of a product in flight is never written). The
// producer's idle warp 1 stages the ids in shared memory: the block's query
// ids and each consumer's one id once (on the Q barrier), each key tile's
// ids (-2 past Skv) and its one id (none where it holds Skv's end) with the
// tile (on its K barrier), so the consumers, at K1's 160 registers, hold
// no state of their own for K8 (kept in registers, the ids and their
// tables spilled 108 bytes). A cross-segment
// score adds exactly 0 and never reaches the running max, which starts at
// K7's floor: a query with no key of its segment (or a block with no tile
// to walk) gets zero rows and the lse -1e4. The instance without kSeg
// compiles to K1's code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int kBlockN = 128;         // keys per tile
constexpr int kRow = 128;            // bytes of a row: one swizzle box
constexpr int kKVBytes = kBlockN * kRow;
constexpr int kZeroBar = 1;          // named barriers kZeroBar + w: consumer w's V zeroing

constexpr int kWG = 3;              // consumer warpgroups, 64 query rows each
constexpr int kStages = 3;
constexpr int kAcc = 36;            // O's accumulator, then P's row sum (columns 64..71)
constexpr int kBlockM = 64 * kWG;
constexpr int kThreads = 128 * (kWG + 1);
constexpr int kConsumers = 128 * kWG;
constexpr int kQBytes = kBlockM * kRow;
constexpr int kOnesOffset = kQBytes + 2 * kStages * kKVBytes;
constexpr int kBarOffset = kOnesOffset + kKVBytes;
constexpr int kBars = 1 + 3 * kStages;  // q_full; k_full, v_full, empty per stage
constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
// K8 (kSeg) adds, past the barriers: the block's run of key tiles; the
// block's query ids and each consumer's one id; per stage the key tile's
// ids and its one id, which the producer's warp 1 writes
constexpr int kSpanOffset = kBarOffset + 8 * kBars;
constexpr int kQIdsOffset = kSpanOffset + 16;
constexpr int kQOneOffset = kQIdsOffset + 4 * kBlockM;
constexpr int kKIdsOffset = kQOneOffset + 16;
constexpr int kKOneOffset = kKIdsOffset + 4 * kStages * kBlockN;
constexpr int kSmemSeg = kKOneOffset + 16 + 1024;
// 65,536 registers an SM: 512 threads launch at 128, then the producer
// gives back down to 32 and the consumers take 160
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;

struct Consumer {
  const uint32_t q_rows;  // this warpgroup's 64 rows of the Q tile
  const int t;
  float scale_log2;
  float acc[kAcc];
  float m[2];
  uint32_t pa[8][4];

  __device__ __forceinline__ void issue_s(float (&sc)[64], uint32_t k_tile) {
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::wgmma_ss<0>(sc, sm90::desc_sw128(q_rows + kk * 32, 16, 1024),
                        sm90::desc_sw128(k_tile + kk * 32, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
  }

  // O += P V; the next 64 output columns (LBO) are the ones box at `ones`,
  // of which the product reads 8
  __device__ __forceinline__ void issue_pv(uint32_t v_tile, uint32_t ones) {
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(pa[kc]);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    const uint32_t lbo = ones - v_tile;
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      sm90::wgmma_rs<1>(acc, pa[kc], sm90::desc_sw128(v_tile + kc * 16 * kRow, lbo, 1024), 1);
    }
    sm90::wgmma_commit();
  }

  // Raw scores of the tile's keys at or past `valid` selected to -1e30.
  __device__ __forceinline__ void mask(float (&sc)[64], int valid) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      sc[i] = col < valid ? sc[i] : vap::kNegInf;
    }
  }

  // The online softmax of raw scores sc (rows g: e < 2, g + 8: e >= 2):
  // the new running max in the log2 domain, p = 2^(sc scale_log2 - m) in
  // place (f32), and the factor alpha[r] that rescales O and l.
  __device__ __forceinline__ void softmax(float (&sc)[64], float (&alpha)[2]) {
    float mx0 = vap::kNegInf, mx1 = vap::kNegInf;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m[0], mx0 * scale_log2), n1 = fmaxf(m[1], mx1 * scale_log2);
    alpha[0] = sm90::ex2(m[0] - n0);
    alpha[1] = sm90::ex2(m[1] - n1);
    m[0] = n0;
    m[1] = n1;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      sc[4 * c] = sm90::ex2(fmaf(sc[4 * c], scale_log2, -n0));
      sc[4 * c + 1] = sm90::ex2(fmaf(sc[4 * c + 1], scale_log2, -n0));
      sc[4 * c + 2] = sm90::ex2(fmaf(sc[4 * c + 2], scale_log2, -n1));
      sc[4 * c + 3] = sm90::ex2(fmaf(sc[4 * c + 3], scale_log2, -n1));
    }
  }

  // O and its row sum rescaled by alpha; p (f32) rounded to bf16 into P's A
  // operands (C chunks 2kc, 2kc + 1 -> k16 step kc).
  __device__ __forceinline__ void rescale_pack(const float (&sc)[64], const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < kAcc / 4; ++c) {
      acc[4 * c] *= alpha[0];
      acc[4 * c + 1] *= alpha[0];
      acc[4 * c + 2] *= alpha[1];
      acc[4 * c + 3] *= alpha[1];
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      pa[c / 2][(c & 1) * 2] = sm90::pack_bf16x2(sc[4 * c], sc[4 * c + 1]);
      pa[c / 2][(c & 1) * 2 + 1] = sm90::pack_bf16x2(sc[4 * c + 2], sc[4 * c + 3]);
    }
  }
};

// K8: the producer's warp 1 stages the ids the consumers compare: the
// block's query ids (-3 past Sq) and each consumer's one id (on the Q
// barrier), then per tile walked its keys' ids (-2 past Skv) and its one id
// (none for the tile that holds Skv's end, which compares), on its K
// barrier once the consumers have released the stage.
template <typename Empty, typename Full>
__device__ __forceinline__ void stage_ids(const sm90::Segments& seg, int sample, int m0, int j0,
                                          int ntiles, int sq, int skv, Empty empty, Full k_full,
                                          uint32_t q_full, unsigned char* smem) {
  int* q_ids_s = reinterpret_cast<int*>(smem + kQIdsOffset);
  int* q_one_s = reinterpret_cast<int*>(smem + kQOneOffset);
  int* k_ids_s = reinterpret_cast<int*>(smem + kKIdsOffset);
  int* k_one_s = reinterpret_cast<int*>(smem + kKOneOffset);
  const int lane = threadIdx.x % 32;
  const sm90::SegTable q_tab = seg.q_table(sample, sq), kv_tab = seg.kv_table(sample, skv);
  const int* qs = seg.q_seg + static_cast<size_t>(sample) * sq;
  const int* kvs = seg.kv_seg + static_cast<size_t>(sample) * skv;
  for (int i = lane; i < kBlockM; i += 32) q_ids_s[i] = m0 + i < sq ? __ldg(qs + m0 + i) : -3;
  if (lane < kWG) q_one_s[lane] = sm90::seg_single(q_tab.range<64>(m0 + 64 * lane));
  sm90::mbar_arrive(q_full);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const int k0 = (j0 + j) * kBlockN, valid = skv - k0;
    sm90::mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
    for (int i = lane; i < kBlockN; i += 32) {
      k_ids_s[s * kBlockN + i] = i < valid ? __ldg(kvs + k0 + i) : -2;
    }
    // the tile that holds Skv's end compares (its ids past Skv are -2)
    if (lane == 0) {
      k_one_s[s] = valid < kBlockN ? sm90::kSegNoHi
                                   : sm90::seg_single(kv_tab.range<kBlockN>(k0));
    }
    sm90::mbar_arrive(k_full(s));
  }
}

template <bool kSeg>
__device__ __forceinline__ void fwd_body(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                         const CUtensorMap& map_v, bf16* __restrict__ o,
                                         float* __restrict__ lse, const int* __restrict__ kv_lens,
                                         const sm90::Segments seg, int heads, int sq, int skv,
                                         float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const uint32_t q_tile = base;
  const uint32_t bars = base + kBarOffset;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + kQBytes + s * kKVBytes; };
  auto v_tile = [&](int s) { return base + kQBytes + (kStages + s) * kKVBytes; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int len = vap::kv_length(kv_lens, bh, heads, skv);
  int ntiles = (len + kBlockN - 1) / kBlockN;
  int j0 = 0;  // the first key tile walked (K8)
  const int sample = bh / heads;
  int2* span_s = reinterpret_cast<int2*>(smem + kSpanOffset);
  int* q_ids_s = reinterpret_cast<int*>(smem + kQIdsOffset);  // [kBlockM]
  int* q_one_s = reinterpret_cast<int*>(smem + kQOneOffset);  // [kWG]
  int* k_ids_s = reinterpret_cast<int*>(smem + kKIdsOffset);  // [kStages][kBlockN]
  int* k_one_s = reinterpret_cast<int*>(smem + kKOneOffset);  // [kStages]
  if constexpr (kSeg) {
    if (threadIdx.x < 32) {
      const sm90::SegTable q_tab = seg.q_table(sample, sq), kv_tab = seg.kv_table(sample, skv);
      const int2 span = sm90::seg_span<kBlockN>(kv_tab, ntiles, q_tab.range<kBlockM>(m0));
      if (threadIdx.x == 0) *span_s = span;
    }
  }

  const uint32_t ones = base + kOnesOffset;
  if (threadIdx.x == 0) {
    // K8: the Q and K barriers also wait for warp 1's ids
    sm90::mbar_init(q_full, kSeg ? 1 + 32 : 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full(s), kSeg ? 1 + 32 : 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  {  // bf16 ones, every column: the swizzle moves nothing
    uint4* box = reinterpret_cast<uint4*>(smem + kOnesOffset);
    for (int i = threadIdx.x; i < kKVBytes / 16; i += kThreads) {
      box[i] = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    }
    sm90::fence_proxy_async();
  }
  __syncthreads();
  if constexpr (kSeg) {
    j0 = span_s->x;
    ntiles = span_s->y - span_s->x;
  }

  if (threadIdx.x < 128) {  // the producer warpgroup
    sm90::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&map_q);
      sm90::tma_prefetch(&map_k);
      sm90::tma_prefetch(&map_v);
      sm90::mbar_arrive_expect_tx(q_full, kQBytes);
      sm90::tma_load_3d(q_tile, &map_q, q_full, 0, m0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        sm90::mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(k_full(s), kKVBytes);
        sm90::tma_load_3d(k_tile(s), &map_k, k_full(s), 0, (j0 + j) * kBlockN, bh);
        sm90::mbar_arrive_expect_tx(v_full(s), kKVBytes);
        sm90::tma_load_3d(v_tile(s), &map_v, v_full(s), 0, (j0 + j) * kBlockN, bh);
      }
    }
    if constexpr (kSeg) {
      if (threadIdx.x / 32 == 1) stage_ids(seg, sample, m0, j0, ntiles, sq, skv, empty, k_full,
                                           q_full, smem);
    }
  } else {  // the consumer warpgroups, 64 query rows each
    sm90::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2;
    Consumer cs{q_tile + w * 64 * kRow, lane & 3, scale_log2};
#pragma unroll
    for (int i = 0; i < kAcc; ++i) cs.acc[i] = 0.0f;
    const float m_init = (kSeg || kv_lens) ? vap::kVarlenFloorLog2 : vap::kNegInf;
    cs.m[0] = cs.m[1] = m_init;
    const int last_valid = len - (ntiles - 1) * kBlockN;  // keys of the last tile below the length

    // K8: the cross-segment scores of the tile in stage s selected out,
    // unless this warpgroup's rows and the tile hold one id, the same (the
    // ids staged by the producer's warp 1, on the barriers already waited)
    auto select = [&](float(&sc)[64], int j) {
      if constexpr (kSeg) {
        const int s = j % kStages;
        const int one = q_one_s[w];
        if (k_one_s[s] != one || one == sm90::kSegNoHi) {
          const int* qi = q_ids_s + w * 64 + warp * 16 + g;
          const int qid[2] = {qi[0], qi[8]};
          const int* ki = k_ids_s + s * kBlockN;
          const uint64_t keep = sm90::seg_keep<kBlockN>(qid, [&](int col) { return ki[col]; });
#pragma unroll
          for (int i = 0; i < 64; ++i) sc[i] = (keep >> i) & 1 ? sc[i] : vap::kNegInf;
        }
      } else {
        if (j == ntiles - 1 && last_valid < kBlockN) cs.mask(sc, last_valid);
      }
    };

    // K7: V rows of the last tile between the length and Skv hold the
    // caller's data; zero them before the P V that reads them
    auto zero_tail = [&](int s) {
      if (len < skv && last_valid < kBlockN) {
        sm90::zero_rows(smem + (v_tile(s) - base), 1, kKVBytes, last_valid,
                        min(kBlockN, skv - (ntiles - 1) * kBlockN), tid, 128, kZeroBar + w);
      }
    };

    sm90::mbar_wait(q_full, 0);
    float sc[64], alpha[2];
    if (ntiles > 0) {  // tile 0: Q K^T and its softmax
      sm90::mbar_wait(k_full(0), 0);
      cs.issue_s(sc, k_tile(0));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      select(sc, 0);
      cs.softmax(sc, alpha);
      cs.rescale_pack(sc, alpha);
    }
    for (int j = 1; j < ntiles; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      sm90::mbar_wait(k_full(s), (j / kStages) & 1);
      sm90::mbar_wait(v_full(sp), ((j - 1) / kStages) & 1);
      cs.issue_s(sc, k_tile(s));  // tile j's Q K^T, then tile j - 1's P V
      cs.issue_pv(v_tile(sp), ones);
      sm90::wgmma_wait<1>();  // Q K^T done; P V may still run
      sm90::fence_regs(sc);
      select(sc, j);
      cs.softmax(sc, alpha);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(cs.acc);
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(cs.pa[kc]);
      sm90::mbar_arrive(empty(sp));
      cs.rescale_pack(sc, alpha);
    }
    if (ntiles > 0) {  // the last tile's P V
      const int s = (ntiles - 1) % kStages;
      sm90::mbar_wait(v_full(s), ((ntiles - 1) / kStages) & 1);
      zero_tail(s);
      cs.issue_pv(v_tile(s), ones);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(cs.acc);
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(cs.pa[kc]);
      sm90::mbar_arrive(empty(s));
    }

    // O / l in bf16 and the natural-log lse, rows below Sq only; l is the
    // accumulator's column 64 (+ 2t), the whole row's sum
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + w * 64 + warp * 16 + g + 8 * r;
      if (row >= sq) continue;
      const float l = cs.acc[32 + 2 * r];
      const float l_safe = l == 0.0f ? 1.0f : l;  // the TPU kernels' l == 0 guard
      const float inv = 1.0f / l_safe;
      bf16* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * cs.t) =
            sm90::pack_bf16x2(cs.acc[4 * c + 2 * r] * inv, cs.acc[4 * c + 2 * r + 1] * inv);
      }
      if (cs.t == 0) {
        lse[static_cast<size_t>(bh) * sq + row] = vap::kLn2 * (cs.m[r] + log2f(l_safe));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90_d64_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ kv_lens, int heads, int sq, int skv, float scale_log2) {
  fwd_body<false>(map_q, map_k, map_v, o, lse, kv_lens, sm90::Segments{}, heads, sq, skv,
                  scale_log2);
}

// K8 (kSeg): no kv_lens, every key below Skv.
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90_d64_seg_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, float* __restrict__ lse,
    const sm90::Segments seg, int heads, int sq, int skv, float scale_log2) {
  fwd_body<true>(map_q, map_k, map_v, o, lse, nullptr, seg, heads, sq, skv, scale_log2);
}

cudaError_t make_maps(CUtensorMap* map_q, CUtensorMap* map_k, CUtensorMap* map_v, const void* q,
                      const void* k, const void* v, int bh, int sq, int skv) {
  cudaError_t err = sm90::make_map(map_q, q, bh, sq, D, kBlockM);
  // no key at all: the maps are never read; q stands in for k and v
  if (err == cudaSuccess) err = sm90::make_map(map_k, skv ? k : q, bh, skv ? skv : sq, D, kBlockN);
  if (err == cudaSuccess) err = sm90::make_map(map_v, skv ? v : q, bh, skv ? skv : sq, D, kBlockN);
  return err;
}

}  // namespace

// C entry point, bound from Python with ctypes: K1, and K7 at head_dim 64.
// q, k, v, o contiguous [bh, s, 64] bf16, 16-byte aligned; lse [bh, sq]
// f32; kv_lens a device pointer to [bh / heads] int32 valid key counts, or
// null (every key valid); scale_log2 = softmax scale * log2(e). Encodes the
// three tensor maps on the host, launches on `stream` and returns the CUDA
// error (0 on success; a refused launch, shared memory included, is an
// error). bh <= 65535, sq >= 1, heads >= 1 divides bh.
extern "C" int vap_flash_fwd_d64(const void* q, const void* k, const void* v, void* o, void* lse,
                                 const void* kv_lens, int bh, int heads, int sq, int skv,
                                 float scale_log2, void* stream) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_maps(&map_q, &map_k, &map_v, q, k, v, bh, sq, skv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_sm90_d64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_sm90_d64_kernel<<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads,
                              kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_lens), heads, sq, skv, scale_log2);
  return cudaGetLastError();
}

// C entry point of K8 at head_dim 64: q, k, v, o and lse as above; q_seg
// [bh / heads, sq] and kv_seg [bh / heads, skv] int32 segment ids (padding
// -1); ranges a device scratch of (bh / heads) * (ceil(sq / 64) + ceil(skv /
// 64)) int2, which the entry fills (the query table, then the key table)
// before the forward reads it. Returns the CUDA error of the launches.
extern "C" int vap_flash_fwd_d64_seg(const void* q, const void* k, const void* v, const void* q_seg,
                                     const void* kv_seg, void* ranges, void* o, void* lse, int bh,
                                     int heads, int sq, int skv, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sm90::Segments seg;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_maps(&map_q, &map_k, &map_v, q, k, v, bh, sq, skv);
  if (err == cudaSuccess) {
    err = sm90::seg_tables(&seg, q_seg, kv_seg, ranges, bh / heads, sq, skv, st);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_d64_seg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemSeg);
  }
  if (err != cudaSuccess) return err;
  flash_fwd_sm90_d64_seg_kernel<<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads, kSmemSeg,
                                  st>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), static_cast<float*>(lse), seg, heads, sq, skv,
      scale_log2);
  return cudaGetLastError();
}

// The (query block rows, key tile rows) of the K8 kernel above, the sizes
// its tile rule counts in; SEGMENT_TILES in ops/flash_attention.py repeats
// them for the CPU and is held against this on the card.
extern "C" int vap_flash_fwd_d64_seg_tiles(int* tiles) {
  tiles[0] = kBlockM;
  tiles[1] = kBlockN;
  return 0;
}
