// K2 and K7's int8 form of it at head_dim 128: the SageAttention-style
// forward redesigned for Hopper on int8 wgmma, TMA and warp specialisation.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_forward_t_i8` (:816; `_fwd_kernel_t_i8` :690,
// `_fwd_kernel_t_i8_bound` :775) at head_dim 128, the forward of Wan's
// joint and cross attention and HunyuanVideo's joint attention under the
// sage provider, and, given kv_lens, K7's int8 form there
// (`flash_attention_int8(kv_lens=)` :957). Entry `vap_sage_fwd_d128`; the
// contract is sage_fwd.cu's: q8 [BH, Sq, 128] and k8 [BH, Skv, 128] int8 (the
// pre-pass's output, sage_quant.cu), v [BH, Skv, 128] bf16 and sqk [BH] f32
// (s_q * s_k * scale * log2 e) -> out [BH, Sq, 128] bf16 and the
// natural-log lse [BH, Sq] f32. Scores are int32 dot products times sqk,
// the log2 domain of the running-max online softmax; P is rounded to bf16
// before P V and before its row sum. kv_lens [B] int32 (or null): sample
// b = bh / heads attends keys [0, kv_lens[b]) only; the running max then
// starts at the floor of -1e4 nats, so a sample with no key gets zero rows
// and the lse -1e4.
//
// What bounds it on an H100: 2 * BH * Sq * Skv * 128 int8 operations at
// 1,979 TOP/s (Q K^T) plus as many bf16 FLOP at 989 TFLOP/s (P V): at Wan's
// joint shape [1, 40, 40560, 128] 25.55 ms, against 0.5 ms of memory. The
// softmax issues per score an integer add and an FADD (the exact int32 ->
// f32 conversion of sm90::s32_to_f32, where the mma.sync kernel issued an
// I2FP), an FMNMX, an FFMA with the scale and the running max, the
// ex2 and half a pack, under the tensor cores' 1.5 clocks of products a
// score at this head_dim. The mma.sync kernel it replaces (sage_fwd.cu's
// D = 128 instance) ran at 17% of the bound (153.3 ms on an H100 at 700 W).
//
// Design (K4's, flash_fwd_sm90.cu, with Q K^T on the int8 tensor cores).
// One block of three warpgroups per (bh, 128-query tile):
//   producer (warpgroup 0, setmaxnreg down to 40): one thread issues the
//     TMA loads: the int8 Q tile once (one box of [128, 128] bytes), then
//     the int8 K tile (16 KB) and the bf16 V tile (32 KB) of 128 keys into
//     a ring of two stages, each with a full barrier for K, one for V and
//     an empty barrier the consumers release;
//   two consumers (setmaxnreg up to 232), 64 query rows each: per key tile
//     S = Q K^T as 4 wgmma m64n128k32 s32.s8.s8 from shared memory (both
//     K-major, 128-byte swizzle), the int32 scores converted exactly to
//     f32 in place, the online softmax in registers, P rounded to bf16, and
//     O += P V as 8 wgmma m64n128k16 with P from registers and V read
//     MN-major from shared memory, as in K4.
// Unlike K4, each warpgroup issues tile j's Q K^T with tile j - 1's P V and
// runs tile j's softmax under the P V (as K1 at head_dim 64), its P kept in
// f32 until that product is waited for (writing P's bf16 registers under a
// product that reads them makes ptxas serialise every wgmma, C7513): with
// the int8 Q K^T half as long, this gained 2.8% over K4's serial loop here
// (it lost 6-8% in K4), and three stages lost 1-2% to two (PERF.md).
// Tensors are 3-D tensor maps [BH, S, D], so a tile past S reads zeros
// inside its own (b, h), never the next head's rows. Shared memory: Q
// 16 KB, each stage 48 KB: 112 KB, one block an SM.
//
// Masks. A key at or past the length (Skv, or kv_lens[b]) is selected to
// -1e30 after the conversion (a select, never a multiply); only the last
// tile can hold one, and the loop stops at it. Between kv_lens[b] and Skv
// its V rows hold the caller's data (NaN in the tests): p is exactly 0
// there, but 0 * NaN is NaN, so each consumer warpgroup zeroes those V rows
// in shared memory before its last P V (a proxy fence and a barrier of its
// own 128 threads; the warpgroups write the same zeros, and no stage is
// refilled before every consumer has released it). K needs no zeroing: the
// pre-pass has zeroed those rows before the smoothing, and the select drops
// their columns.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "sage.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int kBlockM = 128;  // queries per block: two consumer warpgroups of 64 rows
constexpr int kBlockN = 128;  // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // a producer and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kZeroBar = 1;           // named barriers kZeroBar + w: consumer w's V zeroing
constexpr int kQBytes = kBlockM * D;  // int8: a row of 128 bytes, one swizzle box
constexpr int kKBytes = kBlockN * D;
constexpr int kVBox = kBlockN * 128;  // bf16: [128 keys, 64 columns], 128-byte rows
constexpr int kVBytes = kVBox * (D / 64);
constexpr int kKOffset = kQBytes;
constexpr int kVOffset = kKOffset + kStages * kKBytes;
constexpr int kBarOffset = kVOffset + kStages * kVBytes;
constexpr int kBars = 1 + 3 * kStages;  // q_full; k_full, v_full, empty per stage
// the tiles plus the barriers, and 1 KB to align the base to the swizzle
constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

struct Consumer {
  const uint32_t q_rows;  // this warpgroup's 64 rows of the Q tile
  const int t;
  const float sqk;
  float acc[64];
  float m[2];
  float l[2];
  uint32_t pa[8][4];

  // S = Q K^T over 128 bytes of int8: 4 k32 steps, int32 into sc
  __device__ __forceinline__ void issue_s(uint32_t (&sc)[64], uint32_t k_tile) {
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      sm90::wgmma_ss_s8(sc, sm90::desc_sw128(q_rows + kk * 32, 16, 1024),
                        sm90::desc_sw128(k_tile + kk * 32, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
  }

  // O += P V: 8 k16 steps over the tile's keys; V MN-major
  __device__ __forceinline__ void issue_pv(uint32_t v_tile) {
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(pa[kc]);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBlockN / 16; ++kc) {
      sm90::wgmma_rs<1>(acc, pa[kc], sm90::desc_sw128(v_tile + kc * 16 * 128, kVBox, 1024), 1);
    }
    sm90::wgmma_commit();
  }

  // O and l rescaled by alpha; p (f32) rounded to bf16 into P's A operands
  // (C chunks 2kc, 2kc + 1 -> k16 step kc); l sums the rounded p.
  __device__ __forceinline__ void rescale_pack(const uint32_t (&sc)[64], const float (&alpha)[2]) {
    l[0] *= alpha[0];
    l[1] *= alpha[1];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc[4 * c] *= alpha[0];
      acc[4 * c + 1] *= alpha[0];
      acc[4 * c + 2] *= alpha[1];
      acc[4 * c + 3] *= alpha[1];
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(__uint_as_float(sc[4 * c]), __uint_as_float(sc[4 * c + 1]));
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(__uint_as_float(sc[4 * c + 2]), __uint_as_float(sc[4 * c + 3]));
      l[0] += __low2float(lo) + __high2float(lo);
      l[1] += __low2float(hi) + __high2float(hi);
      pa[c / 2][(c & 1) * 2] = *reinterpret_cast<const uint32_t*>(&lo);
      pa[c / 2][(c & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
    }
  }

  __device__ __forceinline__ void wait_pv() {
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(pa[kc]);
  }
};

__global__ void __launch_bounds__(kThreads, 1) sage_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const float* __restrict__ sqk,
    bf16* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kv_lens, int heads,
    int sq, int skv) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = sm90::aligned_base(smem_raw, &smem);
  const uint32_t q_tile = base;
  const uint32_t bars = base + kBarOffset;
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return base + kKOffset + s * kKBytes; };
  auto v_tile = [&](int s) { return base + kVOffset + s * kVBytes; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int len = vap::kv_length(kv_lens, bh, heads, skv);
  const int ntiles = (len + kBlockN - 1) / kBlockN;

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
        sm90::mbar_arrive_expect_tx(k_full(s), kKBytes);
        sm90::tma_load_3d(k_tile(s), &map_k, k_full(s), 0, j * kBlockN, bh);
        sm90::mbar_arrive_expect_tx(v_full(s), kVBytes);
        for (int b = 0; b < D / 64; ++b) {
          sm90::tma_load_3d(v_tile(s) + b * kVBox, &map_v, v_full(s), b * 64, j * kBlockN, bh);
        }
      }
    }
  } else {  // the two consumer warpgroups
    sm90::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;  // rows 64 w .. 64 w + 63 of the tile
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2;
    Consumer cs{q_tile + w * 64 * D, lane & 3, sqk[bh]};
#pragma unroll
    for (int i = 0; i < 64; ++i) cs.acc[i] = 0.0f;
    const float m_init = kv_lens ? vap::kVarlenFloorLog2 : vap::kNegInf;
    cs.m[0] = cs.m[1] = m_init;
    cs.l[0] = cs.l[1] = 0.0f;
    const int last_valid = len - (ntiles - 1) * kBlockN;  // keys of the last tile below the length

    // K7: V rows of the last tile between the length and Skv hold the
    // caller's data; zero them before the P V that reads them
    auto zero_tail = [&](int s) {
      if (len < skv && last_valid < kBlockN) {
        sm90::zero_rows(smem + (v_tile(s) - base), D / 64, kVBox, last_valid,
                        min(kBlockN, skv - (ntiles - 1) * kBlockN), tid, 128, kZeroBar + w);
      }
    };
    auto valid_of = [&](int j) { return j == ntiles - 1 ? last_valid : kBlockN; };

    sm90::mbar_wait(q_full, 0);
    uint32_t sc[64];
    float alpha[2];
    if (ntiles > 0) {  // tile 0: Q K^T and its softmax
      sm90::mbar_wait(k_full(0), 0);
      cs.issue_s(sc, k_tile(0));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sage::convert(sc, valid_of(0), cs.t);
      sage::softmax(sc, cs.m, cs.sqk, alpha);
      cs.rescale_pack(sc, alpha);
    }
    for (int j = 1; j < ntiles; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      sm90::mbar_wait(k_full(s), (j / kStages) & 1);
      sm90::mbar_wait(v_full(sp), ((j - 1) / kStages) & 1);
      cs.issue_s(sc, k_tile(s));  // tile j's Q K^T, then tile j - 1's P V
      cs.issue_pv(v_tile(sp));
      sm90::wgmma_wait<1>();  // Q K^T done; P V may still run
      sm90::fence_regs(sc);
      sage::convert(sc, valid_of(j), cs.t);
      sage::softmax(sc, cs.m, cs.sqk, alpha);
      cs.wait_pv();
      sm90::mbar_arrive(empty(sp));
      cs.rescale_pack(sc, alpha);
    }
    if (ntiles > 0) {  // the last tile's P V
      const int s = (ntiles - 1) % kStages;
      sm90::mbar_wait(v_full(s), ((ntiles - 1) / kStages) & 1);
      zero_tail(s);
      cs.issue_pv(v_tile(s));
      cs.wait_pv();
      sm90::mbar_arrive(empty(s));
    }

    // O / l in bf16 and the natural-log lse, rows below Sq only
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cs.l[r] += __shfl_xor_sync(0xffffffffu, cs.l[r], 1);
      cs.l[r] += __shfl_xor_sync(0xffffffffu, cs.l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + w * 64 + warp * 16 + g + 8 * r;
      if (row >= sq) continue;
      const float l_safe = cs.l[r] == 0.0f ? 1.0f : cs.l[r];  // the TPU kernels' l == 0 guard
      const float inv = 1.0f / l_safe;
      bf16* orow = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * cs.t) =
            sm90::pack_bf16x2(cs.acc[4 * c + 2 * r] * inv, cs.acc[4 * c + 2 * r + 1] * inv);
      }
      if (cs.t == 0) {
        lse[static_cast<size_t>(bh) * sq + row] = vap::kLn2 * (cs.m[r] + log2f(l_safe));
      }
    }
  }
}

}  // namespace

// C entry point, bound from Python with ctypes: K2, and K7's int8 form, at
// head_dim 128. q8, k8 contiguous [bh, s, 128] int8, v and o [bh, s, 128]
// bf16, all 16-byte aligned; sqk [bh] f32; lse [bh, sq] f32; kv_lens a
// device pointer to [bh / heads] int32 valid key counts, or null (every key
// valid). Encodes the three tensor maps on the host, launches on `stream`
// and returns the CUDA error (0 on success; a refused launch, shared memory
// included, is an error). bh <= 65535, sq >= 1, heads >= 1 divides bh.
extern "C" int vap_sage_fwd_d128(const void* q8, const void* k8, const void* sqk, const void* v,
                                 void* o, void* lse, const void* kv_lens, int bh, int heads,
                                 int sq, int skv, void* stream) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = sm90::make_map_i8(&map_q, q8, bh, sq, D, kBlockM);
  // no key at all: the maps are never read; q stands in for k and v
  if (err == cudaSuccess) {
    err = sm90::make_map_i8(&map_k, skv ? k8 : q8, bh, skv ? skv : sq, D, kBlockN);
  }
  if (err == cudaSuccess) err = sm90::make_map(&map_v, skv ? v : o, bh, skv ? skv : sq, D, kBlockN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sage_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  sage_fwd_sm90_kernel<<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<const float*>(sqk), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_lens), heads, sq, skv);
  return cudaGetLastError();
}
