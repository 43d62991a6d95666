// paged_attention: decode attention over a paged KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_attention` in
// src/repro/kernels/paged_attention.py (body `_kernel`), which
// scalar-prefetches the page table so the DMA engine fetches each
// sequence's physical pages in grid order (B, n_max), and carries the
// online-softmax state of all heads in VMEM across the pages.
//
//   out[b,h] = sum over live slots s of softmax_s(q[b,h] . k_s / sqrt(d)) v_s
//
// q is (B, H, d); k_pages and v_pages are (P, page, H, d); page_table is
// (B, n_max) int32, seq_lens (B,) int32.  Slot s of sequence b lives in
// page page_table[b, s / page] at row s % page, and is live when
// s < seq_lens[b] and its page id is not -1.
//
// Pass 1: one warp takes one (b, h, split of pages_per_split pages); four
// warps of a block take four neighbouring heads, so together they read
// each slot's adjacent head rows.  Each warp reads its own page ids (the
// scalar prefetch's counterpart), issues no load for a -1 page (the
// paper's poison) nor for slots at or past seq_len (they are skipped
// outright, never scored: a finite -1e30 score is what made the Pallas
// kernel return the mean of V for a row with nothing live), and clips a
// page id of at least P to P - 1, as repro.kernels.ref does.  Slots go in
// chunks of 8: the 8 key rows load together, 8 dot products reduce by
// butterfly shuffles, then one online-softmax update in f32 and the PV
// product in f32.  Each split writes its (m, l, acc[d]) to scratch.
// Pass 2: one warp per (b, h) folds the splits together; a row with no
// live slot (seq_len 0, or every page -1) writes zeros.
//
// Bound: at Mistral-NeMo-12B decode (B=32, 8 KV heads, d=128, page 16,
// contexts up to 4096, bf16) the call must read each live slot's key and
// value rows once, about 270 MB: 0.08 ms at 3.35 TB/s, against about
// 0.07 GFLOP.  Bytes bound it; the splits (256 tokens each) put enough
// warps in flight to keep many loads outstanding.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kChunk = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

// EPL = d / 32 elements of each row a lane owns (contiguous)
template <typename T, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp,
                   const int32_t* __restrict__ page_table,
                   const int32_t* __restrict__ seq_lens,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int64_t b_n, int64_t h_n, int64_t p_n, int64_t page,
                   int64_t n_max, int64_t pps, int64_t n_split, float scale) {
  constexpr int D = EPL * 32;
  const int lane = threadIdx.x % 32;
  const int64_t h_blocks = (h_n + kWarps - 1) / kWarps;
  const int64_t b = blockIdx.y / h_blocks;
  const int64_t h = (blockIdx.y % h_blocks) * kWarps + threadIdx.x / 32;
  const int64_t split = blockIdx.x;
  if (h >= h_n) return;

  float qv[EPL], acc[EPL];
  const T* qr = q + (b * h_n + h) * D + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    qv[e] = to_f(qr[e]);
    acc[e] = 0.0f;
  }
  float m = -CUDART_INF_F, l = 0.0f;

  const int64_t len = seq_lens[b];
  const int64_t p_end = split * pps + pps < n_max ? split * pps + pps : n_max;
  const int64_t row_stride = h_n * D;  // between slots of one page
  for (int64_t p = split * pps; p < p_end && p * page < len; ++p) {
    int64_t pid = page_table[b * n_max + p];
    if (pid < 0) continue;  // poisoned page: no load at all
    if (pid >= p_n) pid = p_n - 1;
    const int64_t live = len - p * page < page ? len - p * page : page;
    const T* kbase = kp + (pid * page * h_n + h) * D + lane * EPL;
    const T* vbase = vp + (pid * page * h_n + h) * D + lane * EPL;
    for (int64_t s0 = 0; s0 < live; s0 += kChunk) {
      const int n = live - s0 < kChunk ? int(live - s0) : kChunk;
      T kr[kChunk][EPL], vr[kChunk][EPL];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            kr[j][e] = kbase[(s0 + j) * row_stride + e];
            vr[j][e] = vbase[(s0 + j) * row_stride + e];
          }
        }
      }
      float s[kChunk];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.0f;
        if (j < n) {
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            dot = fmaf(qv[e], to_f(kr[j][e]), dot);
        }
        s[j] = warp_sum(dot) * scale;
        if (j < n) mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m, mx);  // finite: n >= 1 slot is live
      const float alpha = __expf(m - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < n) {
          const float pj = __expf(s[j] - m_new);
          sum += pj;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[e] = fmaf(pj, to_f(vr[j][e]), acc[e]);
        }
      }
      l = l * alpha + sum;
      m = m_new;
    }
  }

  const int64_t slot = (b * h_n + h) * n_split + split;
  if (lane == 0) {
    part_ml[2 * slot] = m;
    part_ml[2 * slot + 1] = l;
  }
  float* pa = part_acc + slot * D + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) pa[e] = acc[e];
}

template <typename T, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_combine_kernel(const float* __restrict__ part_ml,
                     const float* __restrict__ part_acc, T* __restrict__ out,
                     int64_t bh_n, int64_t n_split) {
  constexpr int D = EPL * 32;
  const int lane = threadIdx.x % 32;
  const int64_t bh = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (bh >= bh_n) return;
  const float* ml = part_ml + 2 * bh * n_split;
  float big = -CUDART_INF_F;
  for (int64_t i = 0; i < n_split; ++i) big = fmaxf(big, ml[2 * i]);
  float acc[EPL] = {};
  float l = 0.0f;
  if (big != -CUDART_INF_F) {
    for (int64_t i = 0; i < n_split; ++i) {
      if (ml[2 * i] == -CUDART_INF_F) continue;  // split with nothing live
      const float wgt = __expf(ml[2 * i] - big);
      l = fmaf(ml[2 * i + 1], wgt, l);
      const float* pa = part_acc + (bh * n_split + i) * D + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pa[e], wgt, acc[e]);
    }
  }
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;  // dead row: zeros
  T* o = out + bh * D + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[e] = from_f<T>(acc[e] * inv);
}

template <typename T, int EPL>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* sl, void* out, void* scratch, int64_t b_n,
           int64_t h_n, int64_t p_n, int64_t page, int64_t n_max,
           int64_t pps, void* stream) {
  constexpr int D = EPL * 32;
  const int64_t n_split = (n_max + pps - 1) / pps;
  const int64_t h_blocks = (h_n + kWarps - 1) / kWarps;
  if (n_split > 0x7fffffffLL || b_n * h_blocks > 65535)
    return int(cudaErrorInvalidConfiguration);
  float* part_ml = static_cast<float*>(scratch);
  float* part_acc = part_ml + 2 * b_n * h_n * n_split;
  auto s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(float(D));
  const dim3 grid(unsigned(n_split), unsigned(b_n * h_blocks));
  paged_split_kernel<T, EPL><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(sl), part_ml, part_acc, b_n, h_n, p_n,
      page, n_max, pps, n_split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int64_t bh_n = b_n * h_n;
  paged_combine_kernel<T, EPL><<<unsigned((bh_n + kWarps - 1) / kWarps),
                                 kWarps * 32, 0, s>>>(
      part_ml, part_acc, static_cast<T*>(out), bh_n, n_split);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* pt,
             const void* sl, void* out, void* scratch, int64_t b_n,
             int64_t h_n, int64_t d, int64_t p_n, int64_t page,
             int64_t n_max, int64_t pps, void* stream) {
  if (d == 64)
    return launch<T, 2>(q, kp, vp, pt, sl, out, scratch, b_n, h_n, p_n, page,
                        n_max, pps, stream);
  if (d == 128)
    return launch<T, 4>(q, kp, vp, pt, sl, out, scratch, b_n, h_n, p_n, page,
                        n_max, pps, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// scratch: 2 * B * H * n_split + B * H * n_split * d floats, with
// n_split = ceil(n_max / pages_per_split)
extern "C" int paged_attention_f32(const void* q, const void* kp,
                                   const void* vp, const void* pt,
                                   const void* sl, void* out, void* scratch,
                                   long long b, long long h, long long d,
                                   long long p, long long page,
                                   long long n_max, long long pps,
                                   void* stream) {
  return dispatch<float>(q, kp, vp, pt, sl, out, scratch, b, h, d, p, page,
                         n_max, pps, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* kp,
                                    const void* vp, const void* pt,
                                    const void* sl, void* out, void* scratch,
                                    long long b, long long h, long long d,
                                    long long p, long long page,
                                    long long n_max, long long pps,
                                    void* stream) {
  return dispatch<bf16>(q, kp, vp, pt, sl, out, scratch, b, h, d, p, page,
                        n_max, pps, stream);
}
