// K6, and K7's and K8's backward in its form: the bf16 flash-attention
// backward at head_dim 128, redesigned for Hopper on wgmma, TMA and warp
// specialisation.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_backward` (:1271; `_bwd_dq_kernel` :985,
// `_bwd_dkv_kernel` :1016), and, given kv_lens, K7's backward at head_dim
// 128 (`_fav_bwd` :1499). Entry `vap_flash_bwd_d128`; the contract is the
// row-layout backward's (`_flash_attention_backward` :1271): the gradient of
// out = softmax(q k^T * scale) v over [BH, S, 128], non-causal,
// keys past Skv masked, from the natural-log lse of the forward; delta =
// rowsum(out * dout) comes in f32 from the wrapper. Its rounding points:
//   q_s = bf16(q * scale)              (rounded before q k^T)
//   p   = exp(q_s k^T - lse)           (natural base, natural-log lse,
//                                       taken as exp2(x log2 e - lse log2 e))
//   ds  = p (dout v^T - delta)
//   dq  = scale * bf16(ds) k
//   dk  = scale * bf16(ds)^T q         (the unscaled q)
//   dv  = bf16(p)^T dout
// K7: kv_lens [B] int32 (or null): sample b = bh / heads has keys [0,
// kv_lens[b]) only; every query row gets dq from those keys (0 for a sample
// with none), and dk and dv are exact zeros in the rows past the length.
//
// Design. Three kernels on one stream, no atomics, so every sum is made in
// one block in a fixed order and the gradients come out the same from run
// to run (the ring's rank-identical, owner-summed gradients rest on it):
//   scale_q: q_s = bf16(q * scale), written into dq's buffer (its rows are
//     only overwritten, each by the block that read them, in the dq pass);
//   dk/dv: one block per (bh, 128 keys): K and V loaded once by TMA; a
//     loop over query tiles of 64 whose q, q_s and dout come by TMA and
//     whose lse * log2 e and delta rows the producer's second warp writes
//     (+1e30 and 0 past Sq, so a padded query adds nothing), through a ring
//     of kKvStages stages. Each of two consumer warpgroups owns 64 keys:
//     S^T = K q_s^T and dP^T = V dout^T (wgmma m64n64k16, both operands
//     K-major in shared memory), P^T and dS^T in registers, then
//     dv += bf16(P^T) dout and dk += bf16(dS^T) q (wgmma m64n128k16, A
//     from registers, B MN-major in shared memory);
//   dq: one block per (bh, 128 queries), q_s and dout loaded once, K and V
//     tiles of 64 keys through a ring of kDqStages: S = q_s K^T and
//     dP = dout V^T (m64n64k16), dS in registers, dq += bf16(dS) K
//     (m64n128k16, K MN-major).
// A producer warpgroup (setmaxnreg 40) issues the loads; the consumers run
// at 232 registers: the dk and dv accumulators of 64 keys are 128 f32 a
// thread, S^T and dP^T 64 more.
//
// Masks. The dq pass: a key at or past the length gets p = 0 and ds = 0 by
// a select; the tile holding the length is loaded whole, so between a K7
// length and Skv its K rows hold the caller's data (NaN in the tests), and
// the consumers zero them in shared memory before dS K reads them (a NaN in
// V only reaches dP's own column, which the select drops). Past Skv the
// TMA writes zeros. A tile wholly past the length is never loaded. The
// dk/dv pass: a key block wholly past the length writes its zero rows and
// returns; in the block that holds it, the rows past the length are
// computed from whatever they hold and stored as zeros by a select.
//
// What bounds it on an H100: 10 * BH * Sq * Skv * 128 FLOP (five products)
// at 989 TFLOP/s bf16 against the bytes of q, k, v, out, dout, dq, dk, dv
// and lse: at Wan's self-attention [1, 40, 20280, 128] 21.29 ms against
// 0.79 ms of memory: compute bound. Two kernels without atomics compute S
// and dP twice, seven products, so this design cannot beat 7/5 of the
// bound: 29.81 ms at that shape (a dq pass with atomics would lift it, at
// the cost of run-to-run identical gradients). The mma.sync kernels it
// replaces took 149.8 ms, SDPA's flash backward 72.9 ms, these 51.0 ms
// (58% of the ceiling, on an H100 at 700 W).
//
// K8's backward (`_fas_bwd` :1581) at head_dim 128 is the instance kSeg of
// both kernels (flash_bwd_sm90_seg_dkv_kernel, flash_bwd_sm90_seg_dq_kernel,
// entry `vap_flash_bwd_d128_seg`), in this row form (JAX runs the
// transposed form at every head_dim, :1278-1283; the two differ by the
// rounding of q * scale): as in flash_bwd_sm90_d64.cu, the entry builds the
// id range tables, each block walks the run of tiles that meets its own
// rows, a consumer whose 64 rows and the tile hold one id, the same, takes
// K6's path unchanged, and a mixed tile pair selects p and ds of every
// cross-segment pair to 0. A key block with no query tile to walk writes
// dk = dv = 0, a query block with no key tile dq = 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int kBox = 64;  // bf16 columns per TMA box: 128 bytes, the swizzle width
constexpr int kThreads = 384;  // a producer and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse2 = 1e30f;  // lse2 of a padded query row: p = exp2(s - 1e30) = 0

// the dk/dv kernel: 128 keys a block, query tiles of 64
constexpr int kKvN = 128;
constexpr int kKvM = 64;
constexpr int kKvStages = 2;
constexpr int kKvKBox = kKvN * 128;  // bytes of one box of the K (or V) tile
constexpr int kKvQBox = kKvM * 128;  // bytes of one box of a q, q_s or dout tile
constexpr int kKvKBytes = kKvKBox * (D / kBox);
constexpr int kKvQBytes = kKvQBox * (D / kBox);
// per stage: q, q_s, dout; then the lse2 and delta rows of every stage
constexpr int kKvRowsOffset = 2 * kKvKBytes + 3 * kKvStages * kKvQBytes;
constexpr int kKvBarOffset = kKvRowsOffset + 2 * kKvStages * kKvM * 4;
constexpr int kKvBars = 1 + 2 * kKvStages;  // kv_full; full and empty per stage
constexpr int kKvSpanOffset = kKvBarOffset + 8 * kKvBars;  // K8: the block's run of query tiles
constexpr int kKvSmem = kKvSpanOffset + 16 + 1024;

// the dq kernel: 128 queries a block, key tiles of 64
constexpr int kDqM = 128;
constexpr int kDqN = 64;
constexpr int kDqStages = 2;
constexpr int kDqQBox = kDqM * 128;
constexpr int kDqKBox = kDqN * 128;
constexpr int kDqQBytes = kDqQBox * (D / kBox);
constexpr int kDqKBytes = kDqKBox * (D / kBox);
constexpr int kDqBarOffset = 2 * kDqQBytes + 2 * kDqStages * kDqKBytes;
constexpr int kDqBars = 1 + 3 * kDqStages;  // q_full; k_full, v_full, empty per stage
constexpr int kDqSpanOffset = kDqBarOffset + 8 * kDqBars;  // K8: the block's run of key tiles
constexpr int kDqSmem = kDqSpanOffset + 16 + 1024;

// S-type product of a consumer warpgroup: d[64, 64] = A[64 rows, 128] .
// B[64 rows, 128]^T, both K-major tiles of two boxes (box strides in bytes).
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a, uint32_t a_box, uint32_t b,
                                       uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    sm90::wgmma_ss<0>(d, sm90::desc_sw128(a + (kk / 4) * a_box + off, 16, 1024),
                      sm90::desc_sw128(b + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
}

// acc[64, 128] += a[64, 64] . B[64 rows, 128]: a as 4 k16 steps of A
// registers, B an MN-major tile of two boxes of `b_box` bytes.
__device__ __forceinline__ void accumulate(float (&acc)[64], const uint32_t (&a)[4][4], uint32_t b,
                                           uint32_t b_box) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    sm90::wgmma_rs<1>(acc, a[kc], sm90::desc_sw128(b + kc * 16 * 128, b_box, 1024), 1);
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) sm90::fence_regs(a[kc]);
}

// Round a [64, 64] accumulator (the warp's 16 rows) to bf16 A operands:
// chunks 2kc and 2kc + 1 -> k16 step kc.
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j & 1) * 2] = sm90::pack_bf16x2(c[4 * j], c[4 * j + 1]);
    a[j / 2][(j & 1) * 2 + 1] = sm90::pack_bf16x2(c[4 * j + 2], c[4 * j + 3]);
  }
}

// Store a consumer warp's 16 rows [row0, row0 + 16) of acc * mul as bf16
// into the [rows, 128] matrix m: rows at or past `valid` as zeros (a
// select), rows at or past `rows` not at all.
__device__ __forceinline__ void store_rows(const float (&acc)[64], float mul, bf16* m, int row0,
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
    for (int c = 0; c < 16; ++c) {
      const float lo = keep ? acc[4 * c + 2 * r] * mul : 0.0f;
      const float hi = keep ? acc[4 * c + 2 * r + 1] * mul : 0.0f;
      *reinterpret_cast<uint32_t*>(out + 8 * c + 2 * t) = sm90::pack_bf16x2(lo, hi);
    }
  }
}

// q_s = bf16(q * scale), 8 elements a thread, rounded to nearest even.
__global__ void scale_q_kernel(const uint4* __restrict__ q, uint4* __restrict__ q_s, size_t n,
                               float scale) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 x = q[i];
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(w[j] << 16), hi = __uint_as_float(w[j] & 0xffff0000u);
    y[j] = sm90::pack_bf16x2(__fmul_rn(lo, scale), __fmul_rn(hi, scale));
  }
  q_s[i] = make_uint4(y[0], y[1], y[2], y[3]);
}

template <bool kSeg>
__device__ __forceinline__ void dkv_body(
    const CUtensorMap& map_q, const CUtensorMap& map_qs, const CUtensorMap& map_do,
    const CUtensorMap& map_k, const CUtensorMap& map_v, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const int* __restrict__ kv_lens, const sm90::Segments seg, int heads, int sq, int skv,
    float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const uint32_t k_tile = base, v_tile = base + kKvKBytes;
  auto stage_tile = [&](int s, int which) {  // which: 0 q, 1 q_s, 2 dout
    return base + 2 * kKvKBytes + (3 * s + which) * kKvQBytes;
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
      sm90::tma_prefetch(&map_qs);
      sm90::tma_prefetch(&map_do);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * kKvKBytes);
      for (int b = 0; b < D / kBox; ++b) {
        sm90::tma_load_3d(k_tile + b * kKvKBox, &map_k, kv_full, b * kBox, key0, bh);
        sm90::tma_load_3d(v_tile + b * kKvKBox, &map_v, kv_full, b * kBox, key0, bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kKvStages;
        sm90::mbar_wait(empty(s), ((j / kKvStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full(s), 3 * kKvQBytes);
        for (int b = 0; b < D / kBox; ++b) {
          const int c0 = b * kBox, c1 = (j0 + j) * kKvM;
          sm90::tma_load_3d(stage_tile(s, 0) + b * kKvQBox, &map_q, full(s), c0, c1, bh);
          sm90::tma_load_3d(stage_tile(s, 1) + b * kKvQBox, &map_qs, full(s), c0, c1, bh);
          sm90::tma_load_3d(stage_tile(s, 2) + b * kKvQBox, &map_do, full(s), c0, c1, bh);
        }
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
    const uint32_t k_rows = k_tile + cw * 64 * 128, v_rows = v_tile + cw * 64 * 128;

    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

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
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kKvStages;
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
      float st[32], dpt[32];
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);
      sm90::wgmma_fence();
      scores(st, k_rows, kKvKBox, stage_tile(s, 1), kKvQBox);
      scores(dpt, v_rows, kKvKBox, stage_tile(s, 2), kKvQBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      const float* l2 = lse2_s + s * kKvM;
      const float* dl = dl_s + s * kKvM;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);
        const float p = exp2f(fmaf(st[i], kLog2e, -l2[col]));
        dpt[i] = p * (dpt[i] - dl[col]);  // ds^T, in place of dp^T
        st[i] = p;
      }
      if (!pure) {  // K8: a mixed tile pair's cross-segment p^T and ds^T selected to 0
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool k = (keep >> i) & 1;
          st[i] = k ? st[i] : 0.0f;
          dpt[i] = k ? dpt[i] : 0.0f;
        }
      }
      uint32_t pa[4][4], dsa[4][4];
      to_frags(pa, st);
      to_frags(dsa, dpt);

      fence_frags(pa);
      fence_frags(dsa);
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
      accumulate(dv_acc, pa, stage_tile(s, 2), kKvQBox);   // dv += p^T dout
      accumulate(dk_acc, dsa, stage_tile(s, 0), kKvQBox);  // dk += ds^T q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
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
__device__ __forceinline__ void dq_body(const CUtensorMap& map_qs, const CUtensorMap& map_do,
                                        const CUtensorMap& map_k, const CUtensorMap& map_v,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, bf16* __restrict__ dq,
                                        const int* __restrict__ kv_lens, const sm90::Segments seg,
                                        int heads, int sq, int skv, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const uint32_t qs_tile = base, do_tile = base + kDqQBytes;
  auto k_tile = [&](int s) { return base + 2 * kDqQBytes + s * kDqKBytes; };
  auto v_tile = [&](int s) { return base + 2 * kDqQBytes + (kDqStages + s) * kDqKBytes; };
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
      for (int b = 0; b < D / kBox; ++b) {
        sm90::tma_load_3d(qs_tile + b * kDqQBox, &map_qs, q_full, b * kBox, m0, bh);
        sm90::tma_load_3d(do_tile + b * kDqQBox, &map_do, q_full, b * kBox, m0, bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kDqStages;
        sm90::mbar_wait(empty(s), ((j / kDqStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(k_full(s), kDqKBytes);
        for (int b = 0; b < D / kBox; ++b) {
          sm90::tma_load_3d(k_tile(s) + b * kDqKBox, &map_k, k_full(s), b * kBox,
                            (j0 + j) * kDqN, bh);
        }
        sm90::mbar_arrive_expect_tx(v_full(s), kDqKBytes);
        for (int b = 0; b < D / kBox; ++b) {
          sm90::tma_load_3d(v_tile(s) + b * kDqKBox, &map_v, v_full(s), b * kBox,
                            (j0 + j) * kDqN, bh);
        }
      }
    }
  } else {  // the two consumer warpgroups, 64 query rows each
    sm90::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;
    const int cw = tid / 128;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t qs_rows = qs_tile + cw * 64 * 128, do_rows = do_tile + cw * 64 * 128;
    const int row0 = m0 + cw * 64 + warp * 16;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      const size_t at = static_cast<size_t>(bh) * sq + row;
      lse2[r] = row < sq ? lse[at] * kLog2e : kPadLse2;
      dl[r] = row < sq ? delta[at] : 0.0f;
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

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
        keep = ~0ull;
        if (!pure) {
          keep = sm90::seg_keep<kDqN>(
              qid, [&](int col) { return col < valid ? __ldg(kvs + k0 + col) : -2; });
        }
      }

      sm90::mbar_wait(k_full(s), parity);
      if (len < skv && valid < kDqN) {
        // K7: K rows between the length and Skv hold the caller's data
        // (NaN in the tests); zero them before dS K reads them
        sm90::zero_rows(smem + (k_tile(s) - base), D / kBox, kDqKBox, valid,
                        min(kDqN, skv - j * kDqN), tid, kConsumers, 1);
      }

      float sc[32], dp[32];
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
      scores(sc, qs_rows, kDqQBox, k_tile(s), kDqKBox);
      sm90::wgmma_commit();
      sm90::mbar_wait(v_full(s), parity);
      sm90::wgmma_fence();
      scores(dp, do_rows, kDqQBox, v_tile(s), kDqKBox);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // ds = p (dp - delta) in place of s; keys at or past the length give 0
      if (valid < kDqN) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = 8 * (i / 4) + 2 * t + (i & 1);
          const int r = (i >> 1) & 1;
          const bool keep = col < valid;
          const float p = keep ? exp2f(fmaf(sc[i], kLog2e, -lse2[r])) : 0.0f;
          sc[i] = keep ? p * (dp[i] - dl[r]) : 0.0f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2f(fmaf(sc[i], kLog2e, -lse2[r])) * (dp[i] - dl[r]);
        }
      }
      // K8: a mixed tile pair's cross-segment ds selected to 0. The select
      // runs on pure tiles too, its mask all ones: skipped there by a branch,
      // ptxas injected a warpgroup arrive and wait into this kernel (C7519,
      // C7517), which it does not with the select unconditional
      if constexpr (kSeg) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = (keep >> i) & 1 ? sc[i] : 0.0f;
      }
      uint32_t dsa[4][4];
      to_frags(dsa, sc);

      fence_frags(dsa);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      accumulate(acc, dsa, k_tile(s), kDqKBox);  // dq += ds K
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      fence_frags(dsa);
      sm90::mbar_arrive(empty(s));
    }
    // every read of this block's q_s rows (in dq's buffer) is done: the TMA
    // load completed before the loop
    store_rows(acc, scale, dq + static_cast<size_t>(bh) * sq * D, row0, sq, sq);
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_dkv_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_qs,
    const __grid_constant__ CUtensorMap map_do, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const int* __restrict__ kv_lens, int heads, int sq, int skv, float scale) {
  dkv_body<false>(map_q, map_qs, map_do, map_k, map_v, lse, delta, dk, dv, kv_lens,
                  sm90::Segments{}, heads, sq, skv, scale);
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_dq_kernel(
    const __grid_constant__ CUtensorMap map_qs, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    const int* __restrict__ kv_lens, int heads, int sq, int skv, float scale) {
  dq_body<false>(map_qs, map_do, map_k, map_v, lse, delta, dq, kv_lens, sm90::Segments{}, heads,
                 sq, skv, scale);
}

// K8's backward (kSeg): no kv_lens, every key below Skv.
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_seg_dkv_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_qs,
    const __grid_constant__ CUtensorMap map_do, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const sm90::Segments seg, int heads, int sq, int skv, float scale) {
  dkv_body<true>(map_q, map_qs, map_do, map_k, map_v, lse, delta, dk, dv, nullptr, seg, heads,
                 sq, skv, scale);
}

__global__ void __launch_bounds__(kThreads, 1) flash_bwd_sm90_seg_dq_kernel(
    const __grid_constant__ CUtensorMap map_qs, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    const sm90::Segments seg, int heads, int sq, int skv, float scale) {
  dq_body<true>(map_qs, map_do, map_k, map_v, lse, delta, dq, nullptr, seg, heads, sq, skv, scale);
}

// The tensor maps of both kernels (q_s is read from dq's buffer).
struct Maps {
  CUtensorMap kv_q, kv_qs, kv_do, kv_k, kv_v, dq_qs, dq_do, dq_k, dq_v;
};

cudaError_t make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                      const void* dq, int bh, int sq, int skv) {
  // no key at all: the key maps are never read; q stands in for k and v
  const void* kp = skv ? k : q;
  const void* vp = skv ? v : q;
  const int krows = skv ? skv : sq;
  cudaError_t err = sm90::make_map(&m->kv_q, q, bh, sq, D, kKvM);
  if (err == cudaSuccess) err = sm90::make_map(&m->kv_qs, dq, bh, sq, D, kKvM);
  if (err == cudaSuccess) err = sm90::make_map(&m->kv_do, dout, bh, sq, D, kKvM);
  if (err == cudaSuccess) err = sm90::make_map(&m->kv_k, kp, bh, krows, D, kKvN);
  if (err == cudaSuccess) err = sm90::make_map(&m->kv_v, vp, bh, krows, D, kKvN);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_qs, dq, bh, sq, D, kDqM);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_do, dout, bh, sq, D, kDqM);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_k, kp, bh, krows, D, kDqN);
  if (err == cudaSuccess) err = sm90::make_map(&m->dq_v, vp, bh, krows, D, kDqN);
  return err;
}

// q_s = bf16(q * scale) into dq's buffer, on `stream`.
cudaError_t scale_q(const void* q, void* dq, int bh, int sq, float scale, cudaStream_t stream) {
  const size_t n8 = static_cast<size_t>(bh) * sq * D / 8;
  scale_q_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, stream>>>(
      static_cast<const uint4*>(q), static_cast<uint4*>(dq), n8, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound from Python with ctypes: K6, and K7's backward at
// head_dim 128. q, k, v, dout, dq, dk, dv contiguous [bh, s, 128] bf16
// (q, dout, dq: sq rows; k, v, dk, dv: skv rows), 16-byte aligned; lse and
// delta [bh, sq] f32; kv_lens a device pointer to [bh / heads] int32 valid
// key counts (K7) or null; `scale` the softmax scale. Encodes the tensor
// maps on the host, then launches on `stream` the q_s pre-pass (into dq),
// the dk/dv kernel and the dq kernel, and returns the CUDA error of the
// launches (0 on success). bh <= 65535, sq >= 1, heads >= 1 divides bh.
extern "C" int vap_flash_bwd_d128(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                  const void* kv_lens, int bh, int heads, int sq, int skv,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  Maps m;
  cudaError_t err = make_maps(&m, q, k, v, dout, dq, bh, sq, skv);
  if (err == cudaSuccess) err = scale_q(q, dq, bh, sq, scale, st);
  if (err != cudaSuccess) return err;
  if (skv > 0) {  // no key row: dk and dv are empty
    err = cudaFuncSetAttribute(flash_bwd_sm90_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_sm90_dkv_kernel<<<dim3((skv + kKvN - 1) / kKvN, bh), kThreads, kKvSmem, st>>>(
        m.kv_q, m.kv_qs, m.kv_do, m.kv_k, m.kv_v, l, de, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), lens, heads, sq, skv, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(flash_bwd_sm90_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_dq_kernel<<<dim3((sq + kDqM - 1) / kDqM, bh), kThreads, kDqSmem, st>>>(
      m.dq_qs, m.dq_do, m.dq_k, m.dq_v, l, de, static_cast<bf16*>(dq), lens, heads, sq, skv, scale);
  return cudaGetLastError();
}

// C entry point of K8's backward at head_dim 128: the tensors as above;
// q_seg [bh / heads, sq] and kv_seg [bh / heads, skv] int32 segment ids
// (padding -1); ranges a device scratch of (bh / heads) * (ceil(sq / 64) +
// ceil(skv / 64)) int2, which the entry fills (sm90::seg_tables) before the
// kernels read it. Launches the range tables, the q_s pre-pass (into dq),
// the dk/dv kernel and the dq kernel, and returns the CUDA error of the
// launches.
extern "C" int vap_flash_bwd_d128_seg(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, const void* q_seg,
                                      const void* kv_seg, void* ranges, int bh, int heads, int sq,
                                      int skv, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  Maps m;
  sm90::Segments seg;
  cudaError_t err = make_maps(&m, q, k, v, dout, dq, bh, sq, skv);
  if (err == cudaSuccess) {
    err = sm90::seg_tables(&seg, q_seg, kv_seg, ranges, bh / heads, sq, skv, st);
  }
  if (err == cudaSuccess) err = scale_q(q, dq, bh, sq, scale, st);
  if (err != cudaSuccess) return err;
  if (skv > 0) {  // no key row: dk and dv are empty
    err = cudaFuncSetAttribute(flash_bwd_sm90_seg_dkv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_sm90_seg_dkv_kernel<<<dim3((skv + kKvN - 1) / kKvN, bh), kThreads, kKvSmem, st>>>(
        m.kv_q, m.kv_qs, m.kv_do, m.kv_k, m.kv_v, l, de, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), seg, heads, sq, skv, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(flash_bwd_sm90_seg_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_sm90_seg_dq_kernel<<<dim3((sq + kDqM - 1) / kDqM, bh), kThreads, kDqSmem, st>>>(
      m.dq_qs, m.dq_do, m.dq_k, m.dq_v, l, de, static_cast<bf16*>(dq), seg, heads, sq, skv, scale);
  return cudaGetLastError();
}

// The (query block rows, key tile rows) of the K8 dq kernel above and the
// (key block rows, query tile rows) of its dk/dv kernel, the sizes their
// tile rule counts in; SEGMENT_TILES in ops/flash_attention.py repeats them
// for the CPU and is held against this on the card.
extern "C" int vap_flash_bwd_d128_seg_tiles(int* tiles) {
  tiles[0] = kDqM;
  tiles[1] = kDqN;
  tiles[2] = kKvN;
  tiles[3] = kKvM;
  return 0;
}
