// K2 and K7's int8 form of it at head_dim 64: the SageAttention-style
// forward redesigned for Hopper on int8 wgmma, TMA and warp specialisation.
//
// Replaces the TPU kernels of vap_tpu/ops/flash_attention.py
// `_flash_attention_forward_t_i8` (:816; `_fwd_kernel_t_i8` :690,
// `_fwd_kernel_t_i8_bound` :775) at head_dim 64, the forward of CogVideoX's
// joint attention under the sage provider (the bench configuration's), and,
// given kv_lens, K7's int8 form there (`flash_attention_int8(kv_lens=)`
// :957). Entry `vap_sage_fwd_d64`; the contract is sage_fwd.cu's: q8
// [BH, Sq, 64] and k8 [BH, Skv, 64] int8 (the pre-pass's output,
// sage_quant.cu), v [BH, Skv, 64] bf16 and sqk [BH] f32 (s_q * s_k * scale *
// log2 e) -> out [BH, Sq, 64] bf16 and the natural-log lse [BH, Sq] f32.
// Scores are int32 dot products times sqk, the log2 domain of the
// running-max online softmax; P is rounded to bf16 before P V and before its
// row sum. kv_lens [B] int32 (or null): sample b = bh / heads attends keys
// [0, kv_lens[b]) only; the running max then starts at the floor of -1e4
// nats, so a sample with no key gets zero rows and the lse -1e4.
//
// What bounds it on an H100: 2 * BH * Sq * Skv * 64 int8 operations at
// 1,979 TOP/s (Q K^T) plus as many bf16 FLOP at 989 TFLOP/s (P V): at
// CogVideoX's [1, 48, 35552, 64] 11.78 ms, against 0.4 ms of memory. But a
// score costs 0.75 clocks of an SM's tensor cores here and one ex2, 1/16 of
// its MUFU clock: the exponentials alone take 15.7 ms at that shape, above
// the tensor bound, so the softmax's instruction issue sets the pace, as in
// K1 (flash_fwd_sm90_d64.cu). The int32 -> f32 conversion therefore takes
// no conversion instruction (I2F runs at the ex2 rate; the mma.sync kernel
// issued an I2FP a score): an integer add and an FADD a score
// (sm90::s32_to_f32), exact. The mma.sync kernel it
// replaces (sage_fwd.cu's D = 64 instance) ran at 14% of the bound
// (83.6 ms on an H100 at 700 W).
//
// Design (K1's at head_dim 64, with Q K^T on the int8 tensor cores). One
// block of four warpgroups per (bh, 192 queries):
//   producer (warpgroup 0, setmaxnreg 32): one thread issues the TMA loads,
//     the int8 Q tile once, then the int8 K tile (8 KB) and the bf16 V tile
//     (16 KB) of 128 keys into a ring of three stages (a full barrier for
//     K, one for V, an empty barrier that the consumers release);
//   three consumers of 64 query rows each (setmaxnreg 160): S = Q K^T as 2
//     wgmma m64n128k32 s32.s8.s8 from shared memory (both K-major; a row of
//     64 int8 is 64 bytes, so the tiles use the 64-byte swizzle), the int32
//     scores converted to f32 in place, the softmax in registers, and
//     O += P V as 8 wgmma m64n72k16 with P from registers and V read
//     MN-major, beside a box of bf16 ones: the accumulator's columns 64..71
//     are the row sum of the bf16 P, l, with no per-score add.
// Within each warpgroup tile j's Q K^T and tile j - 1's P V are issued
// together, and the softmax of tile j runs while P V is in flight, its P
// kept in f32 until that product is waited for (then packed to bf16:
// writing P's registers under a product that reads them makes ptxas
// serialise every wgmma, warning C7513). Tensors are 3-D tensor maps
// [BH, S, 64], so a tile past S reads zeros inside its own (b, h). Shared
// memory: Q 12 KB, 3 stages of K and V 72 KB, the ones box 16 KB.
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

constexpr int D = 64;
constexpr int kBlockN = 128;         // keys per tile
constexpr int kVRow = 128;           // bytes of a bf16 V row: one 128-byte swizzle box
constexpr int kVBytes = kBlockN * kVRow;
constexpr int kKBytes = kBlockN * D;  // int8: a row of 64 bytes, 64-byte swizzle
constexpr int kZeroBar = 1;          // named barriers kZeroBar + w: consumer w's V zeroing

constexpr int kWG = 3;              // consumer warpgroups, 64 query rows each
constexpr int kStages = 3;
constexpr int kAcc = 36;            // O's accumulator, then P's row sum (columns 64..71)
constexpr int kBlockM = 64 * kWG;
constexpr int kThreads = 128 * (kWG + 1);
constexpr int kConsumers = 128 * kWG;
constexpr int kQBytes = kBlockM * D;
constexpr int kKOffset = kQBytes;
constexpr int kVOffset = kKOffset + kStages * kKBytes;
constexpr int kOnesOffset = kVOffset + kStages * kVBytes;
constexpr int kBarOffset = kOnesOffset + kVBytes;
constexpr int kBars = 1 + 3 * kStages;  // q_full; k_full, v_full, empty per stage
constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
// 65,536 registers an SM: 512 threads launch at 128, then the producer
// gives back down to 32 and the consumers take 160
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;

struct Consumer {
  const uint32_t q_rows;  // this warpgroup's 64 rows of the Q tile
  const int t;
  const float sqk;
  float acc[kAcc];
  float m[2];
  uint32_t pa[8][4];

  // S = Q K^T over 64 bytes of int8: 2 k32 steps, int32 into sc
  __device__ __forceinline__ void issue_s(uint32_t (&sc)[64], uint32_t k_tile) {
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      sm90::wgmma_ss_s8(sc, sm90::desc_sw64(q_rows + kk * 32, 512),
                        sm90::desc_sw64(k_tile + kk * 32, 512), kk > 0);
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
      sm90::wgmma_rs<1>(acc, pa[kc], sm90::desc_sw128(v_tile + kc * 16 * kVRow, lbo, 1024), 1);
    }
    sm90::wgmma_commit();
  }

  // O and its row sum rescaled by alpha; p (f32) rounded to bf16 into P's A
  // operands (C chunks 2kc, 2kc + 1 -> k16 step kc).
  __device__ __forceinline__ void rescale_pack(const uint32_t (&sc)[64], const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < kAcc / 4; ++c) {
      acc[4 * c] *= alpha[0];
      acc[4 * c + 1] *= alpha[0];
      acc[4 * c + 2] *= alpha[1];
      acc[4 * c + 3] *= alpha[1];
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      pa[c / 2][(c & 1) * 2] =
          sm90::pack_bf16x2(__uint_as_float(sc[4 * c]), __uint_as_float(sc[4 * c + 1]));
      pa[c / 2][(c & 1) * 2 + 1] =
          sm90::pack_bf16x2(__uint_as_float(sc[4 * c + 2]), __uint_as_float(sc[4 * c + 3]));
    }
  }

  __device__ __forceinline__ void wait_pv() {
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) sm90::fence_regs(pa[kc]);
  }
};

__global__ void __launch_bounds__(kThreads, 1) sage_fwd_sm90_d64_kernel(
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

  const uint32_t ones = base + kOnesOffset;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full(s), 1);
      sm90::mbar_init(v_full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  {  // bf16 ones, every column: the swizzle moves nothing
    uint4* box = reinterpret_cast<uint4*>(smem + kOnesOffset);
    for (int i = threadIdx.x; i < kVBytes / 16; i += kThreads) {
      box[i] = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);
    }
    sm90::fence_proxy_async();
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
        sm90::tma_load_3d(v_tile(s), &map_v, v_full(s), 0, j * kBlockN, bh);
      }
    }
  } else {  // the consumer warpgroups, 64 query rows each
    sm90::reg_alloc<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2;
    Consumer cs{q_tile + w * 64 * D, lane & 3, sqk[bh]};
#pragma unroll
    for (int i = 0; i < kAcc; ++i) cs.acc[i] = 0.0f;
    const float m_init = kv_lens ? vap::kVarlenFloorLog2 : vap::kNegInf;
    cs.m[0] = cs.m[1] = m_init;
    const int last_valid = len - (ntiles - 1) * kBlockN;  // keys of the last tile below the length

    // K7: V rows of the last tile between the length and Skv hold the
    // caller's data; zero them before the P V that reads them
    auto zero_tail = [&](int s) {
      if (len < skv && last_valid < kBlockN) {
        sm90::zero_rows(smem + (v_tile(s) - base), 1, kVBytes, last_valid,
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
      cs.issue_pv(v_tile(sp), ones);
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
      cs.issue_pv(v_tile(s), ones);
      cs.wait_pv();
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

}  // namespace

// C entry point, bound from Python with ctypes: K2, and K7's int8 form, at
// head_dim 64. q8, k8 contiguous [bh, s, 64] int8, v and o [bh, s, 64] bf16,
// all 16-byte aligned; sqk [bh] f32; lse [bh, sq] f32; kv_lens a device
// pointer to [bh / heads] int32 valid key counts, or null (every key
// valid). Encodes the three tensor maps on the host, launches on `stream`
// and returns the CUDA error (0 on success; a refused launch, shared memory
// included, is an error). bh <= 65535, sq >= 1, heads >= 1 divides bh.
extern "C" int vap_sage_fwd_d64(const void* q8, const void* k8, const void* sqk, const void* v,
                                void* o, void* lse, const void* kv_lens, int bh, int heads, int sq,
                                int skv, void* stream) {
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = sm90::make_map_i8(&map_q, q8, bh, sq, D, kBlockM);
  // no key at all: the maps are never read; q8 and o stand in for k8 and v
  if (err == cudaSuccess) {
    err = sm90::make_map_i8(&map_k, skv ? k8 : q8, bh, skv ? skv : sq, D, kBlockN);
  }
  if (err == cudaSuccess) err = sm90::make_map(&map_v, skv ? v : o, bh, skv ? skv : sq, D, kBlockN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sage_fwd_sm90_d64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  sage_fwd_sm90_d64_kernel<<<dim3((sq + kBlockM - 1) / kBlockM, bh), kThreads, kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<const float*>(sqk), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_lens), heads, sq, skv);
  return cudaGetLastError();
}
