// flash_attention: online-softmax attention, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`), which walks the
// grid (B, H, Tq/bq, Tk/bk) with the key axis innermost and carries the
// running max, sum and accumulator in VMEM scratch across it.
//
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] / sqrt(d)) v[b,h,j]
//
// q is (B, H, tq, d), k and v (B, H, tk, d).  One block takes one
// (b, h, 64-row query tile) and loops over 32-row key tiles itself (the
// TPU's sequential axis), keeping m, l and the output rows in registers:
// 256 threads as 16 row groups of 4 rows x 16 column lanes, the row
// reductions over the 16 lanes by warp shuffles.  Scores, softmax state
// and both products are float32; p is rounded to v's dtype before the PV
// product, as the Pallas kernel does.
//
// Causal masks align bottom-right, as repro.kernels.ref does: query row i
// sees key columns j <= i + tk - tq.  Key tiles wholly past that frontier
// are never loaded (the Pallas grid's top-left test is not carried over).
// A row with no live key (causal rows i < tq - tk) writes zeros.
//
// Bound: at Mistral-NeMo-12B prefill (B=1, H=32, T=4096, d=128, causal,
// bf16) the call does about 137 GFLOP on 134 MB, 0.14 ms of operations at
// 989 TFLOP/s against 0.04 ms of bytes: operations bound it.  This kernel
// runs them on the CUDA cores in f32 (67 TFLOP/s at best), so it sits far
// above the bound by design; tensor cores (mma / wgmma) are the next step.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kBQ = 64, kBK = 32;
constexpr int kMaxDevices = 64;

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

// rows [r0, r0 + ROWS) of a (t, D) matrix into shared s (row stride lds) as
// float, zero past row t
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(float* s, int lds, const T* g,
                                          int64_t r0, int64_t t) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    s[r * lds + c] = r0 + r < t ? to_f(g[(r0 + r) * D + c]) : 0.0f;
  }
}

template <int D>
constexpr int smem_bytes() {
  return ((kBQ + kBK) * (D + 1) + kBK * D + kBQ * (kBK + 1)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int64_t tq,
             int64_t tk, int64_t q_tiles, bool causal, float scale) {
  constexpr int kCols = D / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);      // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);      // [kBK][D]
  float* ps = vs + kBK * D;            // [kBQ][kBK + 1]

  const int64_t bh = blockIdx.x / q_tiles;
  const int64_t q0 = (blockIdx.x % q_tiles) * kBQ;
  const T* qg = q + bh * tq * D;
  const T* kg = k + bh * tk * D;
  const T* vg = v + bh * tk * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t off = tk - tq;  // bottom-right alignment

  // key tiles to visit: all, or those left of the last row's frontier
  int64_t kt_end = (tk + kBK - 1) / kBK;
  if (causal) {
    const int64_t q_last = (q0 + kBQ < tq ? q0 + kBQ : tq) - 1;
    const int64_t last_col = q_last + off;
    const int64_t n = last_col < 0 ? 0 : last_col / kBK + 1;
    if (n < kt_end) kt_end = n;
  }

  load_rows<T, D, kBQ>(qs, D + 1, qg, q0, tq);
  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }

  for (int64_t kt = 0; kt < kt_end; ++kt) {
    const int64_t k0 = kt * kBK;
    load_rows<T, D, kBK>(ks, D + 1, kg, k0, tk);
    load_rows<T, D, kBK>(vs, D, vg, k0, tk);
    __syncthreads();

    // scores of rows ty*4+i, columns tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float k0v = ks[tx * (D + 1) + c];
      const float k1v = ks[(tx + 16) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qs[(ty * 4 + i) * (D + 1) + c];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        const bool live = col < tk && !(causal && col > row + off);
        s[i][j] = live ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing live yet keeps m = -inf, l = 0, o = 0
      const float alpha =
          m_new == -CUDART_INF_F ? 1.0f : __expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = s[i][j] == -CUDART_INF_F ? 0.0f
                                                 : __expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
      }
    }
    __syncthreads();
  }

  T* og = out + bh * tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= tq) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      og[row * D + tx + 16 * c] = from_f<T>(o[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int64_t tq, int64_t tk, bool causal, void* stream) {
  constexpr int kSmem = smem_bytes<D>();
  // above 48 KB of shared memory only after this opt-in, set once per
  // device and instantiation (so on the first call, not inside a graph
  // capture)
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return int(err);
    attr_set[dev] = true;
  }
  const int64_t q_tiles = (tq + kBQ - 1) / kBQ;
  const int64_t blocks = bh * q_tiles;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  const float scale = 1.0f / sqrtf(float(D));
  flash_kernel<T, D><<<unsigned(blocks), kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), tq, tk, q_tiles,
      causal, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int64_t bh, int64_t tq, int64_t tk, int64_t d, int64_t causal,
             void* stream) {
  if (d == 64) return launch<T, 64>(q, k, v, out, bh, tq, tk, causal, stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, out, bh, tq, tk, causal, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, long long bh,
                                   long long tq, long long tk, long long d,
                                   long long causal, void* stream) {
  return dispatch<float>(q, k, v, out, bh, tq, tk, d, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, long long bh,
                                    long long tq, long long tk, long long d,
                                    long long causal, void* stream) {
  return dispatch<bf16>(q, k, v, out, bh, tq, tk, d, causal, stream);
}
