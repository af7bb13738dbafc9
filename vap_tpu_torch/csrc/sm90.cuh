// Hopper (sm_90a) building blocks of the wgmma kernels (attention and the
// GEMMs), as hand-written PTX: the wgmma shared-memory descriptor and the
// fence / commit / wait around the asynchronous products; mbarrier init,
// arrive, expect_tx and try_wait; 3-D TMA loads, multicast to a cluster;
// the cluster's rank, barrier and remote arrivals; setmaxnreg; a named
// barrier and the proxy fence; and, on the host, the 3-D tensor map a
// kernel's TMA loads read, encoded through the driver's
// cuTensorMapEncodeTiled, which the runtime hands out
// (cudaGetDriverEntryPoint): no driver library is linked.
//
// Operand layout. A [rows, D] bf16 tile (D a multiple of 64) lies in shared
// memory as D / 64 boxes of [rows, 64], each row of a box 128 bytes, as a
// TMA load with 128-byte swizzle writes it: the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8). Every box starts on a 1024-byte boundary (the
// swizzle repeats every 8 rows), so a wgmma descriptor in SWIZZLE_128B mode
// reads it back:
//   K-major (the contraction dim contiguous, as Q and K in q k^T): 8-row
//     groups at SBO = 1024 bytes; the k16 step kk of a box starts 32 * kk
//     bytes into it (LBO unused);
//   MN-major (the output dim contiguous, as V in p v: rows are the
//     contraction dim): 8-row groups along the contraction at SBO = 1024
//     bytes, the next 64 output columns (the next box) at LBO = the box's
//     bytes; the k16 step kk starts 16 * 128 * kk bytes in.
// The f32 accumulator of a m64nNk16 wgmma holds, in warp w (of the four in
// the warpgroup) and lane (g = lane / 4, t = lane % 4), element
// d[4j + e] = (row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1)): the
// mma.sync m16n8 C layout repeated over N / 8 column chunks. An A operand
// in registers has the mma.sync m16n8k16 A layout, so C chunks 2kc and
// 2kc + 1 rounded to bf16 pairs are the k16 step kc of a product's A.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory base rounded up to 1 KB, where the swizzle
// pattern starts: its shared address, and a generic pointer to it in *gen.
__device__ __forceinline__ uint32_t aligned_base(unsigned char* raw, unsigned char** gen) {
  const uint32_t r = smem_u32(raw);
  const uint32_t base = (r + 1023u) & ~1023u;
  *gen = raw + (base - r);
  return base;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ---- mbarrier ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// After the inits, before any other thread or the TMA unit uses a barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: parity 1 passes at once, parity 0 waits for the first
// completion).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ----

// Copy the box at coordinates (c0, c1, c2) (innermost first) of `map` into
// shared memory at `dst`; its bytes complete a transaction on `bar`.
// Out-of-range elements are written as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Copy shared memory at `src` into the box at (c0, c1, c2) of `map`, as
// one bulk group of this thread (commit with bulk_commit); elements outside
// the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- clusters ----

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the barriers' inits (and all
// earlier writes) visible cluster-wide after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on the mbarrier at this block's shared address `bar`, in the
// block of rank `rank` of the cluster (this one included). The arrival's
// default semantics (release at CTA scope) are enough to hand a stage's
// shared memory back to a peer's TMA load; release.cluster costs the GEMM
// loop about a third of its rate.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// tma_load_3d into the same shared address of every block of `mask` (bit r:
// rank r), completing the transaction on the barrier at `bar` in each.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// ---- warp specialisation ----

// setmaxnreg, for the whole warpgroup: a producer gives registers back, the
// consumers take them. The roles split once, in one if / else that never
// rejoins, or ptxas ignores it.
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// bar.sync on named barrier `id` (1..15; 0 is __syncthreads) for `threads`.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the MUFU unit, denormal results flushed to zero (a p that small
// rounds to nothing in a bf16 sum of ones).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Orders this thread's generic stores to shared memory before later reads
// by the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Zero rows [r0, r1) of a tile of `boxes` boxes of `box` bytes at the
// generic address `tile`, shared among `threads` threads (this one is
// `tid`), then make the zeros visible to wgmma: a proxy fence and named
// barrier `bar` over the same threads. A whole row of a box is 128 bytes
// whatever its swizzle.
__device__ __forceinline__ void zero_rows(unsigned char* tile, int boxes, int box, int r0, int r1,
                                          int tid, int threads, int bar) {
  for (int i = tid; i < (r1 - r0) * boxes * 8; i += threads) {
    const int r = r0 + i / (boxes * 8), b = (i / 8) % boxes;
    *reinterpret_cast<uint4*>(tile + b * box + r * 128 + (i % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  named_sync(bar, threads);
}

// ---- wgmma ----

// A operands (the mma.sync A layout, 4 k16 steps) of this warp's 16 rows
// of a [64, 64] bf16 tile in one 128-byte-swizzled box at the generic
// address `tile` (1 KB aligned): rows 16 w + g and + 8 of warp w (of its
// warpgroup), columns 16 kk + 2t (+ 8) in 16-byte chunk 2kk (+ 1), which
// the swizzle stores at chunk ^ (row % 8).
__device__ __forceinline__ void load_a_sw128(uint32_t (&a)[4][4], const unsigned char* tile) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1), chunk = 2 * kk + (r >> 1);
      a[kk][r] = *reinterpret_cast<const uint32_t*>(tile + row * 128 + ((chunk ^ g) << 4) + 4 * t);
    }
  }
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr`;
// `lbo` and `sbo` in bytes (see the layout note above).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes to this point of
// the program, so the compiler neither reads an accumulator before its
// wait nor reuses an A operand's registers while a product is in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64, N] (+)= A[64, 16] . B[16, N], bf16 in, f32 out, both operands in
// shared memory (A K-major; B K-major for kTransB = 0, MN-major for 1);
// scale_d = 0 overwrites d. One wgmma of the warpgroup, not waited for.
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// d[64, N] (+)= A[64, 16] . B[16, N] with A in registers (4 bf16 pairs a
// thread, the mma.sync A layout) and B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

// d[64, 72] (+)= A[64, 16] . B[16, 72], A in registers: P V with a column
// of ones beside V's 64, whose accumulator columns 64..71 are P's row sum.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[36], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,"
      "%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35"
      "}, {%36,%37,%38,%39}, %40, p, 1, 1, %42;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

// ---- int8 operands (K2's Q K^T) ----
//
// An int8 [rows, D] tile lies in shared memory with one row of D bytes a
// row, as a TMA load of a [rows, D] box with the swizzle of that width
// writes it: at D = 128, 128-byte swizzle (the layout above, 8-row groups
// of 1024 bytes); at D = 64, 64-byte swizzle: the 16-byte chunk c (of 4) of
// row r sits at chunk c ^ ((r / 2) % 4), 8-row groups of 512 bytes, a tile
// starting on a 512-byte boundary. Both operands of Q K^T are K-major (the
// only layout 8-bit wgmma takes, and the one q_i8 and k_i8 [S, D] have):
// the k32 step kk of a tile starts 32 * kk bytes into it.

// Descriptor of a 64-byte-swizzled K-major operand at shared address
// `addr`; `sbo` in bytes (512 for rows of 64 bytes; LBO unused).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}

// d[64, 128] (+)= A[64, 32] . B[32, 128], int8 in, int32 out, both operands
// K-major in shared memory; scale_d = 0 overwrites d. One wgmma of the
// warpgroup, not waited for. The accumulator layout is the f32 one above.
__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the GEMM main loop's products (gemm_sm90.cuh) ----
//
// Both operands K-major (A [64, K] and B [N, K] as TMA writes 128-byte
// boxes of their rows), or for the bf16 form A MN-major (kTransA = 1: A
// given as [K, 64] rows, the layout V has in P V above). The accumulator
// layout is the one above, over N / 8 column chunks.

// d[64, N] (+)= A[64, 32] . B[32, N] for N = 256 and 192, int8 in, int32
// out, as the m64n128k32 form above.
__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[128], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[96], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64, 256] (+)= A[64, 16] . B[16, 256], bf16 in, f32 out, both operands
// in shared memory, B K-major; A K-major for kTransA = 0, MN-major for 1.
template <int kTransA>
__device__ __forceinline__ void wgmma_ss_tn(float (&d)[128], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
      "}, %128, %129, p, 1, 1, %131, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA));
}

// The int32 x (|x| <= 2^22) as the float x, exactly, with no conversion
// instruction (I2F issues at 16 a clock an SM, the rate of ex2; the I2FP
// ptxas may pick instead has no published rate): x added to the bits of
// 1.5 * 2^23, whose ulp is 1, then 1.5 * 2^23 taken off; an integer add and
// an FADD. An int8 dot product over D <= 128 is within
// D * 127^2 = 2,064,512 < 2^22.
__device__ __forceinline__ float s32_to_f32(uint32_t x) {
  return __int_as_float(static_cast<int>(x + 0x4B400000u)) - 12582912.0f;
}

// ---- packed segments (K8) ----
//
// K8's kernels skip the (query, key) tile pairs that share no segment id.
// Ids are per sample ([B, S] int32, padding -1 as the wrapper maps it, so
// every id is at least -1). A table holds, for each kSegChunk rows of a
// sample, the least and the largest id of its rows below S ({kSegNoLo,
// kSegNoHi} where it has none), padding counted as kSegPad, after every
// segment: a packed stream's padded tail then does not widen the range of
// the tile that holds its last segment's end down to -1. A tile of any multiple of kSegChunk rows
// takes the union of its chunks, and two tiles can hold a pair of equal ids
// only if their ranges meet. A block walks one run of tiles, from the first
// that meets its own range to the last (seg_span): for sorted ids
// (contiguous packing) exactly the tiles that meet it; for unsorted ids a
// tile inside the run that meets no id is loaded too, and its scores
// selected out. A tile pair in which both sides hold one id, the same, is
// pure: every score counts and none is compared.

constexpr int kSegChunk = 64;
constexpr int kSegNoLo = 0x7fffffff;           // the range of no row: meets nothing
constexpr int kSegNoHi = -0x7fffffff - 1;
constexpr int kSegPad = 0x7ffffffe;            // padding (-1) in a range

// One warp per chunk of kChunk rows of the [batch, s] ids: ranges[b * chunks
// + c] = {min, max} of the ids of rows [c kChunk, (c + 1) kChunk) below s.
template <int kChunk>
__global__ void seg_ranges_kernel(const int* __restrict__ ids, int2* __restrict__ ranges, int s,
                                  int chunks, int total) {
  const int w = static_cast<int>((static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (w >= total) return;  // whole warps: blockDim is a multiple of 32
  const int b = w / chunks, c = w % chunks;
  int lo = kSegNoLo, hi = kSegNoHi;
#pragma unroll
  for (int i = lane; i < kChunk; i += 32) {
    const int row = c * kChunk + i;
    if (row < s) {
      const int raw = ids[static_cast<size_t>(b) * s + row];
      const int id = raw < 0 ? kSegPad : raw;
      lo = min(lo, id);
      hi = max(hi, id);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) ranges[w] = make_int2(lo, hi);
}

// The range table of [batch, s] ids into `ranges` (batch * ceil(s /
// kChunk) entries), on `stream`; the CUDA error of the launch. (A template,
// so that only the sources that call it compile the kernel.)
template <int kChunk = kSegChunk>
cudaError_t seg_ranges(const int* ids, int2* ranges, int batch, int s, cudaStream_t stream) {
  const int chunks = (s + kChunk - 1) / kChunk;
  const int total = batch * chunks;
  if (total == 0) return cudaSuccess;
  seg_ranges_kernel<kChunk><<<(total + 7) / 8, 256, 0, stream>>>(ids, ranges, s, chunks, total);
  return cudaGetLastError();
}

// One sample's range table.
struct SegTable {
  const int2* ranges;
  int chunks;

  // The ids range of rows [r0, r0 + kRows), both multiples of kSegChunk:
  // predicated loads, no loop or branch.
  template <int kRows>
  __device__ __forceinline__ int2 range(int r0) const {
    int lo = kSegNoLo, hi = kSegNoHi;
#pragma unroll
    for (int i = 0; i < kRows / kSegChunk; ++i) {
      const int c = r0 / kSegChunk + i;
      const int2 r = c < chunks ? __ldg(ranges + c) : make_int2(kSegNoLo, kSegNoHi);
      lo = min(lo, r.x);
      hi = max(hi, r.y);
    }
    return make_int2(lo, hi);
  }
};

// K8's ids and their range tables, as a kernel takes them.
struct Segments {
  const int* q_seg;    // [B, Sq]
  const int* kv_seg;   // [B, Skv]
  const int2* q_rng;   // [B, ceil(Sq / kSegChunk)]
  const int2* kv_rng;  // [B, ceil(Skv / kSegChunk)]

  __device__ __forceinline__ SegTable q_table(int sample, int sq) const {
    const int chunks = (sq + kSegChunk - 1) / kSegChunk;
    return {q_rng + static_cast<size_t>(sample) * chunks, chunks};
  }
  __device__ __forceinline__ SegTable kv_table(int sample, int skv) const {
    const int chunks = (skv + kSegChunk - 1) / kSegChunk;
    return {kv_rng + static_cast<size_t>(sample) * chunks, chunks};
  }
};

// *seg for the [batch, sq] and [batch, skv] ids q_seg and kv_seg, their
// range tables built on `stream` into `ranges` (batch * (ceil(sq /
// kSegChunk) + ceil(skv / kSegChunk)) int2: the query table, then the key
// table); the CUDA error of the launches.
template <int kChunk = kSegChunk>
cudaError_t seg_tables(Segments* seg, const void* q_seg, const void* kv_seg, void* ranges,
                       int batch, int sq, int skv, cudaStream_t stream) {
  int2* q_rng = static_cast<int2*>(ranges);
  int2* kv_rng = q_rng + static_cast<size_t>(batch) * ((sq + kChunk - 1) / kChunk);
  *seg = {static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), q_rng, kv_rng};
  const cudaError_t err = seg_ranges<kChunk>(seg->q_seg, q_rng, batch, sq, stream);
  return err == cudaSuccess ? seg_ranges<kChunk>(seg->kv_seg, kv_rng, batch, skv, stream) : err;
}

__device__ __forceinline__ bool seg_meet(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// The one id of every row of range r, or kSegNoHi where it holds none or
// several (no tile's range has a single id of kSegNoHi).
__device__ __forceinline__ int seg_single(int2 r) { return r.x == r.y ? r.x : kSegNoHi; }

// Whether the tile of range k is pure against rows of single id `one`.
__device__ __forceinline__ bool seg_pure(int one, int2 k) { return k.x == one && k.y == one; }

// {first, last + 1} of the `ntiles` tiles of kRows rows of table t whose
// range meets r, or {0, 0}; every lane of the calling warp takes part and
// gets it.
template <int kRows>
__device__ __forceinline__ int2 seg_span(const SegTable& t, int ntiles, int2 r) {
  const int lane = threadIdx.x % 32;
  int first = -1, last = -1;
  for (int j0 = 0; j0 < ntiles; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < ntiles && seg_meet(t.range<kRows>(j * kRows), r);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m) {
      if (first < 0) first = j0 + __ffs(m) - 1;
      last = j0 + 31 - __clz(m);
    }
  }
  return first < 0 ? make_int2(0, 0) : make_int2(first, last + 1);
}

// Bit i: whether score i of this thread's share of a [64, N] accumulator
// (row 16w + g + 8 ((i >> 1) & 1), column 8 (i / 4) + 2t + (i & 1)) pairs
// equal ids: the row's id rid[(i >> 1) & 1] and col_id(column).
template <int N, typename ColId>
__device__ __forceinline__ uint64_t seg_keep(const int (&rid)[2], ColId col_id) {
  static_assert(N <= 128, "one bit a score of the thread's N / 2");
  const int t = threadIdx.x % 4;
  uint64_t keep = 0;
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int id = col_id(8 * c + 2 * t + e);
      keep |= static_cast<uint64_t>(id == rid[0]) << (4 * c + e);
      keep |= static_cast<uint64_t>(id == rid[1]) << (4 * c + 2 + e);
    }
  }
  return keep;
}

// ---- host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once; null if the driver
// does not have it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A contiguous [planes, rows, d] bf16 tensor at `base` (16-byte aligned, d
// a multiple of 64) as a 3-D tensor map whose box is [1, box_rows, 64] with
// 128-byte swizzle. A box that runs past `rows` reads zeros there, never the
// next plane's rows. rows == 0 is mapped as one row (never read).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int planes, int rows, int d,
                            int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t r = rows > 0 ? rows : 1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), r, static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2, r * d * 2};  // bytes
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous [planes, rows, d] int8 tensor at `base` (16-byte aligned;
// d = 64 or 128) as a 3-D tensor map whose box is [1, box_rows, d]: a row of
// d bytes, 128-byte swizzle at d = 128 and 64-byte at d = 64 (the layouts
// desc_sw128 and desc_sw64 read). As make_map: a box past `rows` reads zeros
// there; rows == 0 is mapped as one row (never read).
inline cudaError_t make_map_i8(CUtensorMap* map, const void* base, int planes, int rows, int d,
                               int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (d != 64 && d != 128) return cudaErrorInvalidValue;
  const cuuint64_t r = rows > 0 ? rows : 1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), r, static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d), r * d};  // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(d), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              d == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous [rows, cols] matrix of `elem` bytes a value (1: int8, 2:
// bf16, 4: int32) at `base` (16-byte aligned, a row a multiple of 16
// bytes) as a 3-D tensor map of one plane whose box is [1, box_rows, 128
// bytes], 128-byte swizzle: the layout desc_sw128 reads (as make_map_i8 at
// d = 128 and make_map, for rows of any width and each type). A box past
// `rows` or `cols` reads zeros there, and a store skips it.
inline cudaError_t make_map_rows(CUtensorMap* map, const void* base, int rows, int cols, int elem,
                                 int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (rows < 1 || cols < 1 || (static_cast<long long>(cols) * elem) % 16 ||
      (elem != 1 && elem != 2 && elem != 4))
    return cudaErrorInvalidValue;
  const CUtensorMapDataType type = elem == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_INT32;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(cols) * elem;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows), 1};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * rows};  // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult res = encode(map, type, 3, const_cast<void*>(base), dims, strides, box, one,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
