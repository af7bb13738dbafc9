// K4, and K7's and K8's forms of it: the bf16 flash-attention forward at
// head_dim 128, redesigned for Hopper on wgmma, TMA and warp specialisation.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_forward` (:225; `_fwd_kernel` :115,
// `_fwd_kernel_scalar_bound` :179), the row-layout forward at head_dim 128
// that Wan's joint and cross attention and HunyuanVideo's joint attention
// take, and, given kv_lens, K7's forward there (`flash_attention_varlen`
// :1471). Entry `vap_flash_fwd_d128`; the contract is flash_fwd.cu's: q
// [BH, Sq, 128], k and v [BH, Skv, 128] bf16 -> out [BH, Sq, 128] bf16 and
// the natural-log lse [BH, Sq] f32, non-causal, keys past Skv masked, the
// running-max online softmax in the log2 domain (scale_log2 = scale *
// log2 e from the wrapper), P rounded to bf16 before P V and before its row
// sum. kv_lens [B] int32 (or null): sample b = bh / heads attends keys
// [0, kv_lens[b]) only; the running max then starts at the floor of -1e4
// nats, so a sample with no key gets zero rows and the lse -1e4.
//
// Design (the FlashAttention-3 forward, simple first). One block of three
// warpgroups per (bh, 128-query tile):
//   producer (warpgroup 0, setmaxnreg down to 40): one thread issues the
//     TMA loads: the Q tile once, then K and V tiles of 128 keys into a
//     ring of kStages stages, each with a full barrier for K, one for V and
//     an empty barrier the consumers release;
//   two consumers (setmaxnreg up to 232), 64 query rows each: per key tile
//     S = Q K^T as 8 wgmma m64n128k16 from shared memory (K-major Q and K),
//     the online softmax in registers, P rounded to bf16 in registers, and
//     O += P V as 8 wgmma m64n128k16 with P from registers and V read
//     MN-major (transposed) from shared memory.
// The two consumers share each K and V tile; while one runs its softmax the
// other's products keep the tensor cores busy. Tensors are 3-D tensor maps
// [BH, S, 128] in boxes [1, rows, 64] (128 bytes, the swizzle width; a row
// of 128 is two boxes), so a tile that runs past S reads zeros inside its
// own (b, h), never the next head's rows. Shared memory: Q 32 KB, each
// stage 64 KB: 160 KB with two stages, one block an SM.
//
// Masks. A key at or past the length (Skv, or kv_lens[b]) is selected to
// -1e30 in the scores (a select, never a multiply), and only the last tile
// can hold one. The loop stops at the length, so a tile wholly past it is
// never loaded; the one that holds it is loaded whole: past Skv the TMA
// writes zeros, but between kv_lens[b] and Skv its rows hold whatever the
// caller's tensor holds there (NaN in the tests). Their p is exactly 0, yet
// 0 * NaN is NaN, so the consumers zero those V rows in shared memory before
// P V reads them (then a proxy fence and a barrier of the 256 consumer
// threads). K needs no zeroing: a NaN key only makes its own score column
// NaN, and the select drops it.
//
// What bounds it on an H100: 4 * BH * Sq * Skv * 128 FLOP at 989 TFLOP/s
// bf16 against the bytes of q, k, v, out and lse: at Wan's joint shape
// [1, 40, 40560, 128] 34.07 ms of tensor-core time against 0.54 ms of
// memory: compute bound. The mma.sync kernel it replaces ran at 18% of that
// (186.7 ms), SDPA's flash backend at 37% (91.5 ms), this kernel at 52%
// (64.8 ms on an H100 at 700 W). Variants that overlap one tile's softmax
// with the previous tile's P V inside a warpgroup, with or without the two
// consumers taking turns at the tensor cores on named barriers, ran 6-35%
// slower and are not kept (PERF.md); writing P's bf16 registers while
// products are in flight makes ptxas serialise them (C7513). Left for
// later: persistent scheduling, a TMA-store epilogue.
//
// K8, the packed-segment forward (`flash_attention_segmented` :1539), is
// the instance kSeg (flash_fwd_sm90_seg_kernel, entry
// `vap_flash_fwd_d128_seg`), as in flash_fwd_sm90_d64.cu: the entry builds
// the id range tables (sm90.cuh), warp 0 finds the block's run of key tiles
// whose range meets its 128 rows', producer and consumers walk that run
// only; per tile, a consumer whose 64 rows and the key tile hold one id, the
// same, takes K4's path unchanged, else each score whose ids differ is
// selected to -1e30 where K4's mask runs (keys' ids from global memory, -2
// past Skv). The running max starts at K7's floor: a query with no key of
// its segment gets zero rows and the lse -1e4.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int kBlockM = 128;  // queries per block: two consumer warpgroups of 64 rows
constexpr int kBlockN = 128;  // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // a producer and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kBox = 64;              // bf16 columns per TMA box: 128 bytes, the swizzle width
constexpr int kQBox = kBlockM * 128;  // bytes of one box of the Q tile
constexpr int kKVBox = kBlockN * 128;
constexpr int kQBytes = kQBox * (D / kBox);
constexpr int kKVBytes = kKVBox * (D / kBox);
constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
constexpr int kBars = 1 + 3 * kStages;  // q_full; k_full, v_full, empty per stage
constexpr int kSpanOffset = kBarOffset + 8 * kBars;  // K8: the block's run of key tiles
// the tiles, the barriers and the run, and 1 KB to align the base to the swizzle
constexpr int kSmem = kSpanOffset + 16 + 1024;

constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

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
  sm90::SegTable q_tab{}, kv_tab{};
  const int sample = bh / heads;
  int2& span_s = *reinterpret_cast<int2*>(smem + kSpanOffset);
  if constexpr (kSeg) {
    q_tab = seg.q_table(sample, sq);
    kv_tab = seg.kv_table(sample, skv);
    if (threadIdx.x < 32) {
      const int2 span = sm90::seg_span<kBlockN>(kv_tab, ntiles, q_tab.range<kBlockM>(m0));
      if (threadIdx.x == 0) span_s = span;
    }
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
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
      sm90::tma_prefetch(&map_q);
      sm90::tma_prefetch(&map_k);
      sm90::tma_prefetch(&map_v);
      sm90::mbar_arrive_expect_tx(q_full, kQBytes);
      for (int b = 0; b < D / kBox; ++b) {
        sm90::tma_load_3d(q_tile + b * kQBox, &map_q, q_full, b * kBox, m0, bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        sm90::mbar_wait(empty(s), ((j / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(k_full(s), kKVBytes);
        for (int b = 0; b < D / kBox; ++b) {
          sm90::tma_load_3d(k_tile(s) + b * kKVBox, &map_k, k_full(s), b * kBox,
                            (j0 + j) * kBlockN, bh);
        }
        sm90::mbar_arrive_expect_tx(v_full(s), kKVBytes);
        for (int b = 0; b < D / kBox; ++b) {
          sm90::tma_load_3d(v_tile(s) + b * kKVBox, &map_v, v_full(s), b * kBox,
                            (j0 + j) * kBlockN, bh);
        }
      }
    }
  } else {  // the two consumer warpgroups
    sm90::reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x - 128;  // 0..255
    const int cw = tid / 128;           // rows 64 cw .. 64 cw + 63 of the tile
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_rows = q_tile + cw * 64 * 128;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    const float m_init = (kSeg || kv_lens) ? vap::kVarlenFloorLog2 : vap::kNegInf;
    float m[2] = {m_init, m_init};
    float l[2] = {0.0f, 0.0f};

    // K8: this warpgroup's rows' one id (or none) and the thread's two rows' ids
    int q_one = 0, qid[2] = {0, 0};
    const int* kvs = nullptr;
    if constexpr (kSeg) {
      q_one = sm90::seg_single(q_tab.range<64>(m0 + cw * 64));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + cw * 64 + warp * 16 + g + 8 * r;
        qid[r] = row < sq ? __ldg(seg.q_seg + static_cast<size_t>(sample) * sq + row) : -3;
      }
      kvs = seg.kv_seg + static_cast<size_t>(sample) * skv;
    }

    sm90::mbar_wait(q_full, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const int valid = len - (j0 + j) * kBlockN;  // keys of this tile below the length (>= 1)

      // S = Q K^T over D = 128: 8 k16 steps, 4 per box
      float sc[64];
      sm90::mbar_wait(k_full(s), parity);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da = sm90::desc_sw128(q_rows + (kk / 4) * kQBox + off, 16, 1024);
        const uint64_t db = sm90::desc_sw128(k_tile(s) + (kk / 4) * kKVBox + off, 16, 1024);
        sm90::wgmma_ss<0>(sc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // scores in the log2 domain; keys at or past the length selected out,
      // and (K8) every score whose ids differ unless the tile pair is pure
      bool pure = true;
      uint64_t keep = 0;
      if constexpr (kSeg) {
        const int k0 = (j0 + j) * kBlockN;
        pure = sm90::seg_pure(q_one, kv_tab.range<kBlockN>(k0));
        if (!pure) {
          keep = sm90::seg_keep<kBlockN>(
              qid, [&](int col) { return col < valid ? __ldg(kvs + k0 + col) : -2; });
        }
      }
      if (!pure) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = (keep >> i) & 1 ? sc[i] * scale_log2 : vap::kNegInf;
      } else if (valid < kBlockN) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = 8 * (i / 4) + 2 * t + (i & 1);
          sc[i] = col < valid ? sc[i] * scale_log2 : vap::kNegInf;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      }

      // the online softmax: rows g (e < 2) and g + 8 (e >= 2) of the warp
      float mx0 = m[0], mx1 = m[1];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = exp2f(m[0] - mx0), alpha1 = exp2f(m[1] - mx1);
      m[0] = mx0;
      m[1] = mx1;
      l[0] *= alpha0;
      l[1] *= alpha1;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        acc[4 * c] *= alpha0;
        acc[4 * c + 1] *= alpha0;
        acc[4 * c + 2] *= alpha1;
        acc[4 * c + 3] *= alpha1;
      }
      // P in bf16 as the A operand of P V (chunks 2kc, 2kc + 1 -> step kc);
      // l sums the rounded P
      uint32_t pa[8][4];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(exp2f(sc[4 * c] - mx0), exp2f(sc[4 * c + 1] - mx0));
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(exp2f(sc[4 * c + 2] - mx1), exp2f(sc[4 * c + 3] - mx1));
        l[0] += __low2float(lo) + __high2float(lo);
        l[1] += __low2float(hi) + __high2float(hi);
        pa[c / 2][(c & 1) * 2] = *reinterpret_cast<const uint32_t*>(&lo);
        pa[c / 2][(c & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }

      sm90::mbar_wait(v_full(s), parity);
      if (len < skv && valid < kBlockN) {
        // K7: V rows between the length and Skv hold the caller's data
        // (NaN in the tests); zero them before P V reads them
        sm90::zero_rows(smem + (v_tile(s) - base), D / kBox, kKVBox, valid,
                        min(kBlockN, skv - j * kBlockN), tid, kConsumers, 1);
      }

      // O += P V: 8 k16 steps over the tile's keys; V MN-major
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(pa[kc]);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        const uint64_t db = sm90::desc_sw128(v_tile(s) + kc * 16 * 128, kKVBox, 1024);
        sm90::wgmma_rs<1>(acc, pa[kc], db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(pa[kc]);
      sm90::mbar_arrive(empty(s));
    }

    // O / l in bf16 and the natural-log lse, rows below Sq only
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + cw * 64 + warp * 16 + g + 8 * r;
      if (row >= sq) continue;
      const float l_safe = l[r] == 0.0f ? 1.0f : l[r];  // the TPU kernels' l == 0 guard
      const float inv = 1.0f / l_safe;
      bf16* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t) =
            sm90::pack_bf16x2(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
      }
      if (t == 0) lse[static_cast<size_t>(bh) * sq + row] = vap::kLn2 * (m[r] + log2f(l_safe));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ kv_lens, int heads, int sq, int skv, float scale_log2) {
  fwd_body<false>(map_q, map_k, map_v, o, lse, kv_lens, sm90::Segments{}, heads, sq, skv,
                  scale_log2);
}

// K8 (kSeg): no kv_lens, every key below Skv.
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_sm90_seg_kernel(
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

// C entry point, bound from Python with ctypes: K4, and K7 at head_dim 128.
// q, k, v, o contiguous [bh, s, 128] bf16, 16-byte aligned; lse [bh, sq]
// f32; kv_lens a device pointer to [bh / heads] int32 valid key counts, or
// null (every key valid); scale_log2 = softmax scale * log2(e). Encodes the
// three tensor maps on the host, launches on `stream` and returns the CUDA
// error (0 on success; a refused launch, shared memory included, is an
// error). bh <= 65535, sq >= 1, heads >= 1 divides bh.
extern "C" int vap_flash_fwd_d128(const void* q, const void* k, const void* v, void* o, void* lse,
                                  const void* kv_lens, int bh, int heads, int sq, int skv,
                                  float scale_log2, void* stream) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_maps(&map_q, &map_k, &map_v, q, k, v, bh, sq, skv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_sm90_kernel<<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_lens), heads, sq, skv, scale_log2);
  return cudaGetLastError();
}

// C entry point of K8 at head_dim 128: q, k, v, o and lse as above; q_seg
// [bh / heads, sq] and kv_seg [bh / heads, skv] int32 segment ids (padding
// -1); ranges a device scratch of (bh / heads) * (ceil(sq / 64) + ceil(skv /
// 64)) int2, which the entry fills (the query table, then the key table)
// before the forward reads it. Returns the CUDA error of the launches.
extern "C" int vap_flash_fwd_d128_seg(const void* q, const void* k, const void* v,
                                      const void* q_seg, const void* kv_seg, void* ranges, void* o,
                                      void* lse, int bh, int heads, int sq, int skv,
                                      float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sm90::Segments seg;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_maps(&map_q, &map_k, &map_v, q, k, v, bh, sq, skv);
  if (err == cudaSuccess) {
    err = sm90::seg_tables(&seg, q_seg, kv_seg, ranges, bh / heads, sq, skv, st);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_fwd_sm90_seg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  }
  if (err != cudaSuccess) return err;
  flash_fwd_sm90_seg_kernel<<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads, kSmem, st>>>(
      map_q, map_k, map_v, static_cast<bf16*>(o), static_cast<float*>(lse), seg, heads, sq, skv,
      scale_log2);
  return cudaGetLastError();
}

// The (query block rows, key tile rows) of the K8 kernel above, the sizes
// its tile rule counts in; SEGMENT_TILES in ops/flash_attention.py repeats
// them for the CPU and is held against this on the card.
extern "C" int vap_flash_fwd_d128_seg_tiles(int* tiles) {
  tiles[0] = kBlockM;
  tiles[1] = kBlockN;
  return 0;
}
