// The Hopper GEMM main loop shared by K3 (w8a8.cu) and the K9/K10 rate
// probe (gemm_probe.cu): C[M, N] = A[M, K] B[N, K]^T with int8 x int8 ->
// int32 (wgmma m64nNk32) or bf16 x bf16 -> f32 (wgmma m64n256k16), on TMA,
// an mbarrier ring and warp specialisation, in a persistent grid of
// 2-block clusters.
//
// Operands. B is [N, K], K contiguous (the weight as it lies). A is [M, K],
// K contiguous, or, for bf16 only (kTransA), given transposed as xt [K, M]
// and read MN-major by the wgmma (8-bit wgmma takes K-major operands only).
// A stage of the ring holds 128 bytes of K of both tiles (128 int8 or 64
// bf16 values), as TMA writes them with 128-byte swizzle (sm90.cuh):
//   A: [128 rows, 128 bytes] (16 KB), or for xt two boxes [64 k, 64 m]
//      (8 KB each), one per consumer warpgroup;
//   B: [BN rows, 128 bytes];
// one k-step of a wgmma is 32 bytes of K (k32 for s8, k16 for bf16), four
// a stage. Rows of A past M and of B past N, and bytes past K, are TMA's
// zero fill, so M, N and K may be ragged inside a tile; the TMA stores
// clip.
//
// Roles. One block of 384 threads an SM:
//   producer (warpgroup 0, setmaxnreg down to 40): one thread issues the
//     TMA loads of every stage into a ring of kStages, each with a full
//     barrier (the stage's bytes) and an empty barrier the consumers
//     release;
//   two consumers (setmaxnreg up to 232), rows 0-63 and 64-127 of the
//     tile: per stage four wgmma into one accumulator of m64nBN, the first
//     product of a chunk with scale_d = 0 (which overwrites the
//     accumulator: no reset loop); a stage is released when the products of
//     the next are issued and those of its own are done (wait_group 1).
//     At the end of a chunk (all of K for the probe; a quantisation chunk
//     of K3) they wait for every product and hand the accumulator to the
//     kernel's body (K3 folds it into f32); after the last chunk the body
//     stores the tile through OutStage.
// Clusters. Two blocks on neighbouring SMs take two tiles on top of each
// other along M, with the same N columns: each block's producer loads its
// own A tile and half of the B tile, multicast into both blocks, so L2
// serves each B byte once for two tiles. Every consumer warpgroup releases
// a stage in both blocks (one arrival each), and a producer that has
// issued its last load waits for its ring to be released before the block
// may exit (the peer may still arrive on its barriers until then).
// Persistent grid. As many clusters as can run at once (at most one a
// cluster tile) each walk cluster tiles c, c + clusters, ... in a grouped
// order: kGroupM cluster rows by every N tile, M fastest, so the blocks
// running at one time share x rows and w columns in L2. The ring runs on
// across tiles: the producer loads the next tile's first stages while the
// consumers finish and store the last one.
//
// What bounds it on an H100: operations (2MNK at 1,979 TOP/s int8 or 989
// TFLOP/s bf16) at every shape the port runs. A stage feeds 2 x 4 products
// of 64 x BN x 32 bytes (1,024 clocks of the int8 tensor cores at BN =
// 256) from 16 KB of A and BN x 64 bytes of B a block: 32 bytes a clock an
// SM from L2 (48 without the multicast).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace vap {
namespace gemm90 {

constexpr int kBM = 128;        // rows of a tile: two consumer warpgroups of 64
constexpr int kBoxBytes = 128;  // bytes of K a stage
constexpr int kHalfA = 64 * kBoxBytes;  // one consumer's 64 rows of A in a stage
constexpr int kThreads = 384;
constexpr int kCluster = 2;  // blocks a cluster, on top of each other along M
constexpr int kGroupM = 8;   // cluster rows a group of the walk
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kOutBox = 64 * 128;  // an output box: 64 rows of 128 bytes

// Shared memory: the stages, two output boxes a consumer warpgroup, kAux
// bytes of the kernel's own, the barriers; and 1 KB to align the base to
// the swizzle.
template <int BN, int kStages, int kAux = 0>
struct Ring {
  static constexpr int kABytes = kBM * kBoxBytes;
  static constexpr int kBBytes = BN * kBoxBytes;
  static constexpr int kBHalf = kBBytes / kCluster;  // the B rows one block's producer loads
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOutOffset = kStages * kStageBytes;
  static constexpr int kAuxOffset = kOutOffset + 2 * 2 * kOutBox;
  static constexpr int kBarOffset = kAuxOffset + kAux;
  static constexpr int kSmem = kBarOffset + 16 * kStages + 1024;
  static_assert(kBHalf % 1024 == 0, "a B box must keep the next on the swizzle's 1 KB");
  static_assert(kAux % 16 == 0, "the barriers must stay 8-byte aligned");
  static_assert(kSmem <= 232448, "the ring does not fit in shared memory");

  uint32_t base;       // shared address of the 1 KB-aligned base
  unsigned char* gen;  // the same, as a generic pointer
  __device__ __forceinline__ uint32_t a(int s) const { return base + s * kStageBytes; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + kABytes; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + kBarOffset + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return full(kStages + s); }

  // The barriers, by thread 0, then every thread of the cluster waits: the
  // peer's multicast and arrivals land on initialised barriers. Each empty
  // barrier takes one arrival from each consumer warpgroup of the cluster.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        sm90::mbar_init(full(s), 1);
        sm90::mbar_init(empty(s), 2 * kCluster);
      }
      sm90::mbar_fence_init();
    }
    sm90::cluster_sync();
  }
};

// This block's output tiles in the walk's order. Cluster tiles are two M
// tiles by one N tile; they go in groups of kGroupM cluster rows (fewer in
// the last group) by all N tiles, M fastest inside a group.
struct TileWalk {
  int rows, n_tiles, bn;  // cluster rows: ceil(M tiles / 2)
  uint32_t rank;          // this block's rank in its cluster

  __device__ __forceinline__ TileWalk(int m, int n, int bn_)
      : rows(((m + kBM - 1) / kBM + kCluster - 1) / kCluster),
        n_tiles((n + bn_ - 1) / bn_),
        bn(bn_),
        rank(sm90::cluster_rank()) {}
  __device__ __forceinline__ int count() const { return rows * n_tiles; }
  __device__ __forceinline__ int first() const { return blockIdx.x / kCluster; }
  __device__ __forceinline__ int stride() const { return gridDim.x / kCluster; }
  __device__ __forceinline__ void coords(int t, int& m0, int& n0) const {
    const int per_group = kGroupM * n_tiles;
    const int first_row = t / per_group * kGroupM;
    const int group_rows = min(kGroupM, rows - first_row);
    const int r = t % per_group;
    m0 = ((first_row + r % group_rows) * kCluster + static_cast<int>(rank)) * kBM;
    n0 = r / group_rows * bn;
  }
};

// The producer thread: every stage of every tile of this block, in order.
// kElem: bytes a value; map_a is x [M, K] (box [128 rows, 128 bytes]) or,
// with kTransA, xt [K, M] (box [64 k, 64 m]); map_b is w (box [BN / 2
// rows, 128 bytes]). Then it waits for the whole ring to be released (the
// block must outlive its peer's arrivals).
template <int BN, int kStages, int kAux, int kElem, bool kTransA>
__device__ __forceinline__ void produce(const Ring<BN, kStages, kAux>& ring,
                                        const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        const TileWalk& walk, int nk) {
  using R = Ring<BN, kStages, kAux>;
  constexpr int kBoxK = kBoxBytes / kElem;  // K values a stage
  sm90::tma_prefetch(map_a);
  sm90::tma_prefetch(map_b);
  const int b_row = static_cast<int>(walk.rank) * (BN / kCluster);
  uint32_t it = 0;
  for (int t = walk.first(); t < walk.count(); t += walk.stride()) {
    int m0, n0;
    walk.coords(t, m0, n0);
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(ring.empty(s), ((it / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(ring.full(s), R::kStageBytes);
      if (kTransA) {
        sm90::tma_load_3d(ring.a(s), map_a, ring.full(s), m0, kb * kBoxK, 0);
        sm90::tma_load_3d(ring.a(s) + kHalfA, map_a, ring.full(s), m0 + 64, kb * kBoxK, 0);
      } else {
        sm90::tma_load_3d(ring.a(s), map_a, ring.full(s), kb * kBoxK, m0, 0);
      }
      sm90::tma_load_3d_multicast(ring.b(s) + walk.rank * R::kBHalf, map_b, ring.full(s),
                                  kb * kBoxK, n0 + b_row, 0, (1u << kCluster) - 1);
    }
  }
  for (int i = 0; i < kStages; ++i, ++it) {
    sm90::mbar_wait(ring.empty(it % kStages), ((it / kStages) & 1) ^ 1);
  }
}

// The products of one stage, not waited for: four k32 steps of int8, both
// operands K-major; the first with scale_d = 0 when `first`.
template <int N>
__device__ __forceinline__ void issue_stage(uint32_t (&acc)[N], uint32_t a, uint32_t b,
                                            bool first) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBoxBytes / 32; ++kk) {
    sm90::wgmma_ss_s8(acc, sm90::desc_sw128(a + kk * 32, 16, 1024),
                      sm90::desc_sw128(b + kk * 32, 16, 1024), first && kk == 0 ? 0 : 1);
  }
  sm90::wgmma_commit();
}

// The same in bf16, four k16 steps; A K-major, or MN-major with kTransA
// (the k16 step kk then starts 16 rows of 128 bytes into the box).
template <bool kTransA>
__device__ __forceinline__ void issue_stage_bf16(float (&acc)[128], uint32_t a, uint32_t b,
                                                 bool first) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBoxBytes / 32; ++kk) {
    const uint64_t da = kTransA ? sm90::desc_sw128(a + kk * 16 * 128, kHalfA, 1024)
                                : sm90::desc_sw128(a + kk * 32, 16, 1024);
    sm90::wgmma_ss_tn<kTransA ? 1 : 0>(acc, da, sm90::desc_sw128(b + kk * 32, 16, 1024),
                                        first && kk == 0 ? 0 : 1);
  }
  sm90::wgmma_commit();
}

// A consumer warpgroup's output: its [64, BN] band of a tile, through two
// buffers of [64 rows, 128 bytes] in shared memory and TMA stores of `map`
// (box [64 rows, 128 bytes]), a box of kBoxCols columns at a time:
//   begin_box();  put(jj, r, v) for the box's column pairs jj and row
//   halves r;  end_box(col0, row0).
// put writes the values of columns 8 jj + 2 t, + 1 of row 16 warp + g +
// 8 r (the accumulator layout) as one uint2 (4-byte outputs) or one packed
// uint32 (bf16), chunk c of a row at chunk c ^ (row % 8) (the 128-byte
// swizzle: a warp's writes are conflict-free). One thread issues the
// stores and, before a buffer is written again, waits until the store two
// boxes back has read it; named barrier 1 + w orders the warpgroup's
// writes around it. Storing from registers straight to global memory (8
// rows of 16 or 32 bytes a warp instruction) held the consumers for a
// sixth to a third of a tile's time; this way the stores run under the
// next box's writes and the next tile's products.
template <int BN, int kOutBytes>
struct OutStage {
  static constexpr int kBoxCols = 128 / kOutBytes;  // output columns a box
  static constexpr int kBoxes = BN / kBoxCols;       // boxes a band
  static constexpr int kBoxPairs = kBoxCols / 8;     // column pairs a box, a thread
  unsigned char* buf;  // this warpgroup's two buffers (generic)
  uint32_t buf_s;      // and their shared address
  const CUtensorMap* map;
  int w;
  uint32_t used;  // boxes this warpgroup has stored (the buffer is used % 2)

  __device__ __forceinline__ void begin_box() const {
    if (used >= 2 && threadIdx.x % 128 == 0) sm90::bulk_wait_read<1>();
    sm90::named_sync(1 + w, 128);
  }
  template <class V>
  __device__ __forceinline__ void put(int jj, int r, V v) const {
    const int tid = threadIdx.x % 128, g = (tid % 32) >> 2;
    const int row = 16 * (tid / 32) + g + 8 * r;
    const int byte = (8 * jj + 2 * (tid & 3)) * kOutBytes;
    *reinterpret_cast<V*>(buf + (used & 1) * kOutBox + row * 128 + (((byte >> 4) ^ g) << 4) +
                          (byte & 15)) = v;
  }
  __device__ __forceinline__ void end_box(int col0, int row0) {
    sm90::fence_proxy_async();
    sm90::named_sync(1 + w, 128);
    if (threadIdx.x % 128 == 0) {
      sm90::tma_store_3d(map, buf_s + (used & 1) * kOutBox, col0, row0, 0);
      sm90::bulk_commit();
    }
    ++used;
  }
  // Before the block exits: every store has read its buffer.
  __device__ __forceinline__ void finish() const {
    if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();
  }
};

// Consumer warpgroup w's OutStage in `ring`, storing through `map`.
template <int kOutBytes, int BN, int kStages, int kAux>
__device__ __forceinline__ OutStage<BN, kOutBytes> out_stage(const Ring<BN, kStages, kAux>& ring,
                                                             int w, const CUtensorMap* map) {
  const int off = Ring<BN, kStages, kAux>::kOutOffset + w * 2 * kOutBox;
  return {ring.gen + off, ring.base + off, map, w, 0u};
}

// A consumer warpgroup (w = 0 or 1: rows 64 w .. 64 w + 63 of each tile)
// over every tile of this block. The body provides
//   begin(n0)                    before a tile's first stage;
//   chunk_begin(c, m0)           before the first stage of chunk c (K3 loads
//                                its rows' scales there, under the products);
//   issue(a, b, first)           the products of a stage (issue_stage or
//                                issue_stage_bf16);
//   chunk_end(c, m0)             after every product of chunk c is done: it
//                                must fence the accumulator first;
//   store(m0, n0)                after the tile's last chunk.
// A tile is `chunks` chunks of `boxes` stages.
template <int BN, int kStages, int kAux, class Body>
__device__ __forceinline__ void consume(const Ring<BN, kStages, kAux>& ring, const TileWalk& walk,
                                        int chunks, int boxes, Body& body) {
  const int w = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  // warp c's first lane releases a stage in the cluster's block c
  auto release = [&](int s) {
    if (tid % 32 == 0 && tid / 32 < kCluster) sm90::mbar_arrive_cluster(ring.empty(s), tid / 32);
  };
  uint32_t it = 0;
  for (int t = walk.first(); t < walk.count(); t += walk.stride()) {
    int m0, n0;
    walk.coords(t, m0, n0);
    body.begin(n0);
    for (int c = 0; c < chunks; ++c) {
      body.chunk_begin(c, m0);
      int pending = -1;  // the stage whose products may still run
      for (int j = 0; j < boxes; ++j, ++it) {
        const int s = it % kStages;
        sm90::mbar_wait(ring.full(s), (it / kStages) & 1);
        body.issue(ring.a(s) + w * kHalfA, ring.b(s), j == 0);
        sm90::wgmma_wait<1>();
        if (pending >= 0) release(pending);
        pending = s;
      }
      sm90::wgmma_wait<0>();
      if (pending >= 0) release(pending);
      body.chunk_end(c, m0);
    }
    body.store(m0, n0);
  }
}

// Launch `kernel` (built with __cluster_dims__(kCluster, 1, 1)) on a
// persistent grid: as many clusters as can run at once on this device, at
// most one a cluster tile. Returns the CUDA error (a refused launch
// included).
template <typename... Params, typename... Args>
cudaError_t launch_persistent(void (*kernel)(Params...), int smem, int m, int n, int bn,
                              cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, clusters = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(sms / kCluster * kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const long long tiles =
      static_cast<long long>(((m + kBM - 1) / kBM + kCluster - 1) / kCluster) *
      ((n + bn - 1) / bn);
  const int grid = static_cast<int>(tiles < clusters ? tiles : clusters) * kCluster;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace gemm90
}  // namespace vap
