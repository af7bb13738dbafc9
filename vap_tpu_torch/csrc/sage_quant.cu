// K2's quantisation pre-pass, on the card: q and k bf16 -> q_i8, k_i8 int8
// and sqk = s_q * s_k * scale * log2 e, what sage_fwd*.cu take.
//
// Replaces the pre-pass of vap_tpu/ops/flash_attention.py
// `_flash_attention_forward_t_i8` (:835-852), which ran in XLA outside the
// Pallas kernel: K smoothing (k minus its token mean per (b, h, d)), then
// symmetric int8 with one scale per (b, h) for q and for the smoothed k,
// rounded half to even; with kv_lens (K7) the key rows at or past
// kv_lens[b] are taken as 0 before the smoothing, whose mean still runs
// over all Skv rows. The plain version is `sage_quantize` in
// vap_tpu_torch/ops/flash_attention.py: q_i8 and s_q come out bit-equal to
// it (the abs-max is exact in any order, and the scale and quotient are the
// same IEEE divisions, rounded half to even; this file is built without
// --use_fast_math), k_i8 within one step where the mean, summed in another
// order, moves a quotient across a rounding boundary.
//
// Three kernels in a row on one stream:
//   1. sage_stats_kernel, per (bh, chunk of rows): max|q|, and per d the
//      sum, max and min of k (rows past the length selected to 0, never
//      multiplied: a NaN there reaches nothing), into per-chunk partials;
//   2. sage_scales_kernel, per bh: the partials reduced in chunk order
//      (deterministic), mean = sum / Skv, and the smoothed abs-max with no
//      second pass over k: max|k - mean| = max over d of
//      max(kmax[d] - mean[d], mean[d] - kmin[d]), exact in f32 because a
//      rounded subtraction is monotone (the 0 of a row past the length is
//      in kmax and kmin, as it is in the plain version's tensor);
//   3. sage_quant_kernel, per (bh, chunk): q_i8 = rn(q / s_q),
//      k_i8 = rn((k - mean) / s_k), true divisions (a multiply by the
//      reciprocal would move quotients across rounding boundaries).
// What bounds it on an H100: bytes. q and k are read twice (statistics,
// then the quantise pass) and int8 written once: at CogVideoX's
// [1, 48, 35552, 64] 1.09 GB, 0.33 ms at 3.35 TB/s; the plain version
// makes an f32 copy of each and runs a full pass over it per step.
// Each thread moves 16 bytes of bf16 (8 values) a row, a block of 256
// threads the rows of one chunk of one (b, h).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Partials per (bh, chunk): [qmax, ksum[d], kmax[d], kmin[d]]; stats per
// bh: [s_q, s_k, mean[d]].
__host__ __device__ constexpr int part_size(int d) { return 1 + 3 * d; }
__host__ __device__ constexpr int stats_size(int d) { return 2 + d; }

__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(int8_t* p, const int (&v)[8]) {
  uint2 u;
  u.x = (v[0] & 0xFF) | ((v[1] & 0xFF) << 8) | ((v[2] & 0xFF) << 16) | ((v[3] & 0xFF) << 24);
  u.y = (v[4] & 0xFF) | ((v[5] & 0xFF) << 8) | ((v[6] & 0xFF) << 16) | ((v[7] & 0xFF) << 24);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__global__ void __launch_bounds__(kThreads) sage_stats_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const int* __restrict__ kv_lens,
    float* __restrict__ part, int heads, int sq, int skv, int d, int rows) {
  __shared__ float red[3][kThreads * 8];  // per thread: its 8 columns' sum, max, min
  __shared__ float qred[kThreads / 32];
  const size_t bh = blockIdx.y;
  const int c = blockIdx.x;
  const int vecs = d / 8;           // 16-byte vectors a row
  const int step = kThreads / vecs;  // rows a pass
  const int vec = threadIdx.x % vecs, r0 = threadIdx.x / vecs;
  const bool active = r0 < step;
  const int len = vap::kv_length(kv_lens, bh, heads, skv);
  const int first = c * rows;

  float qmax = 0.0f;
  float sum[8], mx[8], mn[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i] = 0.0f, mx[i] = -inf(), mn[i] = inf();
  if (active) {
    const int q_end = min(sq, first + rows);
#pragma unroll 4
    for (int r = first + r0; r < q_end; r += step) {
      float x[8];
      load8(q + (bh * sq + r) * d + vec * 8, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) qmax = fmaxf(qmax, fabsf(x[i]));
    }
    const int k_end = min(skv, first + rows);
#pragma unroll 4
    for (int r = first + r0; r < k_end; r += step) {
      float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (r < len) load8(k + (bh * skv + r) * d + vec * 8, x);  // past the length: 0
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sum[i] += x[i];
        mx[i] = fmaxf(mx[i], x[i]);
        mn[i] = fminf(mn[i], x[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red[0][threadIdx.x * 8 + i] = sum[i];
    red[1][threadIdx.x * 8 + i] = mx[i];
    red[2][threadIdx.x * 8 + i] = mn[i];
  }
  for (int o = 16; o > 0; o /= 2) qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  if (threadIdx.x % 32 == 0) qred[threadIdx.x / 32] = qmax;
  __syncthreads();

  float* out = part + (bh * gridDim.x + c) * part_size(d);
  if (threadIdx.x < d) {  // column threadIdx.x: its row groups in order
    const int v = threadIdx.x / 8, i = threadIdx.x % 8;
    float s = 0.0f, hi = -inf(), lo = inf();
    for (int g = 0; g < step; ++g) {
      const int at = (g * vecs + v) * 8 + i;
      s += red[0][at];
      hi = fmaxf(hi, red[1][at]);
      lo = fminf(lo, red[2][at]);
    }
    out[1 + threadIdx.x] = s;
    out[1 + d + threadIdx.x] = hi;
    out[1 + 2 * d + threadIdx.x] = lo;
  }
  if (threadIdx.x == 0) {
    float m = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, qred[w]);
    out[0] = m;
  }
}

__global__ void __launch_bounds__(128) sage_scales_kernel(const float* __restrict__ part,
                                                         float* __restrict__ stats,
                                                         float* __restrict__ sqk, int chunks,
                                                         int skv, int d, float scale) {
  __shared__ float red[4];
  const size_t bh = blockIdx.x;
  const int col = threadIdx.x;
  float qmax = 0.0f, sum = 0.0f, hi = -inf(), lo = inf();
  for (int c = 0; c < chunks; ++c) {  // in chunk order: the same sum on every run
    const float* p = part + (bh * chunks + c) * part_size(d);
    qmax = fmaxf(qmax, p[0]);
    if (col < d) {
      sum += p[1 + col];
      hi = fmaxf(hi, p[1 + d + col]);
      lo = fminf(lo, p[1 + 2 * d + col]);
    }
  }
  const float mean = sum / static_cast<float>(skv);
  // max over the column's rows of |k - mean|, exactly (see the note above)
  float a = col < d ? fmaxf(hi - mean, mean - lo) : 0.0f;
  for (int o = 16; o > 0; o /= 2) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  if (col % 32 == 0) red[col / 32] = a;
  __syncthreads();
  float* st = stats + bh * stats_size(d);
  if (col < d) st[2 + col] = mean;
  if (col == 0) {
    const float kabs = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
    const float s_q = fmaxf(qmax / 127.0f, 1e-8f);
    const float s_k = fmaxf(kabs / 127.0f, 1e-8f);
    st[0] = s_q;
    st[1] = s_k;
    sqk[bh] = s_q * s_k * scale * kLog2e;  // in the plain version's order
  }
}

__global__ void __launch_bounds__(kThreads) sage_quant_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const int* __restrict__ kv_lens,
    const float* __restrict__ stats, int8_t* __restrict__ q8, int8_t* __restrict__ k8, int heads,
    int sq, int skv, int d, int rows) {
  const size_t bh = blockIdx.y;
  const int vecs = d / 8, step = kThreads / vecs;
  const int vec = threadIdx.x % vecs, r0 = threadIdx.x / vecs;
  if (r0 >= step) return;
  const int len = vap::kv_length(kv_lens, bh, heads, skv);
  const int first = blockIdx.x * rows;
  const float* st = stats + bh * stats_size(d);
  const float s_q = st[0], s_k = st[1];
  float mean[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mean[i] = st[2 + vec * 8 + i];

  const int q_end = min(sq, first + rows);
#pragma unroll 4
  for (int r = first + r0; r < q_end; r += step) {
    float x[8];
    int v[8];
    const size_t at = (bh * sq + r) * d + vec * 8;
    load8(q + at, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __float2int_rn(x[i] / s_q);
    store8(q8 + at, v);
  }
  const int k_end = min(skv, first + rows);
#pragma unroll 4
  for (int r = first + r0; r < k_end; r += step) {
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int v[8];
    const size_t at = (bh * skv + r) * d + vec * 8;
    if (r < len) load8(k + at, x);  // past the length: 0, as in the statistics
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __float2int_rn((x[i] - mean[i]) / s_k);
    store8(k8 + at, v);
  }
}

}  // namespace

// C entry point, bound from Python with ctypes. q [bh, sq, d] and k
// [bh, skv, d] contiguous bf16, 16-byte aligned; kv_lens a device pointer
// to [bh / heads] int32 valid key counts, or null; q8 [bh, sq, d] and k8
// [bh, skv, d] int8 and sqk [bh] f32 written; scratch a device buffer of
// at least bh * (chunks * (1 + 3 d) + 2 + d) f32, its contents overwritten.
// Rows are taken in `chunks` chunks per (b, h) (chunks >= 1). d a multiple
// of 8, at most 128; sq, skv >= 1. Launches the three kernels on `stream`
// and returns the first CUDA error (0 on success).
extern "C" int vap_sage_quant(const void* q, const void* k, const void* kv_lens, void* q8,
                              void* k8, void* sqk, void* scratch, int bh, int heads, int sq,
                              int skv, int d, int chunks, float scale, void* stream) {
  if (d % 8 || d > 128 || chunks < 1 || sq < 1 || skv < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = (max(sq, skv) + chunks - 1) / chunks;
  float* part = static_cast<float*>(scratch);
  float* stats = part + static_cast<size_t>(bh) * chunks * part_size(d);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const int* lens = static_cast<const int*>(kv_lens);
  sage_stats_kernel<<<dim3(chunks, bh), kThreads, 0, s>>>(qb, kb, lens, part, heads, sq, skv, d,
                                                          rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sage_scales_kernel<<<bh, 128, 0, s>>>(part, stats, static_cast<float*>(sqk), chunks, skv, d,
                                        scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sage_quant_kernel<<<dim3(chunks, bh), kThreads, 0, s>>>(
      qb, kb, lens, stats, static_cast<int8_t*>(q8), static_cast<int8_t*>(k8), heads, sq, skv, d,
      rows);
  return cudaGetLastError();
}
