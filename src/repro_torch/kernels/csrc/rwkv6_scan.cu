// rwkv6_scan: the RWKV-6 recurrence over time, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the `jax.lax.scan` of `rwkv6_block` in src/repro/models/ssm.py
// (its `step`), which XLA compiles into one loop on the device.  No Pallas
// kernel computes it; the port's first version ran it as a Python loop of
// about a dozen launches a token (`ref.rwkv6_scan`, the plain version).
//
//   kv_t  = k_t^T v_t                      (rounded to the activations' dtype)
//   y_t   = r_t (S_{t-1} + diag(u) kv_t)   (the sum rounded to r's dtype
//                                           first; the product sums in f32)
//   S_t   = diag(w_t) S_{t-1} + kv_t       (float32)
//
// r, k, v, w are (B, T, H, hd) in float32 or bfloat16, u (H, hd) in their
// dtype, the state (B, H, hd, hd) float32 with row i the key index and
// column j the value index.
//
// Forward: one block per (batch, head), hd threads; thread j owns column j
// of the state, hd float32 registers.  Each step stages r_t, k_t and w_t
// (and u once) in shared memory, double-buffered: a thread loads its own
// element of the next token's r, k, w, v into registers before it computes
// this token and stores them into the other buffer after, so one
// __syncthreads a step orders both.  y_t[j] is thread j's own sum over
// rows: no cross-thread reduction.  Every rounding is the plain version's:
// __fmul_rn / __fadd_rn keep nvcc from contracting k·v, S + u·kv and the
// state update into FMAs that the plain version's separate elementwise
// ops do not make, so the state is bitwise the plain version's on the
// card; y differs by the read-out's order of summation.
//
// Backward: the same forward runs again and writes S_{t-1} of every step
// into a float32 workspace (B * H * T * hd * hd * 4 bytes: 4.3 GB at
// RWKV-6-7B's width, B = 2, T = 2048), then a second kernel walks time
// backward with the state's cotangent G (column j in thread j's
// registers):
//
//   dM[i,j]  = r_i dy_j                    dr_i = sum_j M[i,j] dy_j
//   dkv      = G + u_i dM                  dw_i = sum_j G[i,j] S_{t-1}[i,j]
//   dk_i     = sum_j dkv[i,j] v_j          dv_j = sum_i dkv[i,j] k_i
//   du_i    += sum_j dM[i,j] kv[i,j]       G    = diag(w_t) G + dM
//
// The four sums over j (across threads) go 16 rows at a time through a
// butterfly reduce-scatter of warp shuffles (15 shuffles for 16 rows; one
// more joins the two half-warps), then the warps' partials meet in shared
// memory.  du sums over time in the thread of its row, over the batch by
// one float32 atomic add a block.  Gradients are float32 throughout and
// round once to the inputs' dtypes; the roundings of the forward are
// taken as the identity (autograd's cast gradient).
//
// Bound: 7 hd^2 operations a (batch, token, head) forward, float32 on the
// CUDA cores (67 TFLOP/s); at RWKV-6-7B prefill (B = 8, T = 512, H = 64,
// hd = 64) 7.5 GFLOP a layer, 112 us, against 185 MB of inputs and outputs
// (55 us).  Only B * H blocks of hd threads run, and the recurrence is
// serial in T, so a step's latency, not the card's rate, sets the time.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
// a float32 value rounded to T and widened again
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// OUT: write y and the last state; SAVE: write S_{t-1} of every step
// into ws (B, H, T, hd, hd)
template <typename T, int HD, bool OUT, bool SAVE>
__global__ void __launch_bounds__(HD)
rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const T* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ y, float* __restrict__ s_out,
                 float* __restrict__ ws, int64_t n_t, int64_t n_h) {
  __shared__ float sr[2][HD], sk[2][HD], sw[2][HD], su[HD];
  const int j = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / n_h, h = bh % n_h;
  const auto at = [&](int64_t t) { return ((b * n_t + t) * n_h + h) * HD + j; };
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s0[(bh * HD + i) * HD + j];
  su[j] = to_f(u[h * HD + j]);
  sr[0][j] = to_f(r[at(0)]);
  sk[0][j] = to_f(k[at(0)]);
  sw[0][j] = to_f(w[at(0)]);
  float vj = to_f(v[at(0)]);
  __syncthreads();
  for (int64_t t = 0; t < n_t; ++t) {
    const int cur = t & 1;
    float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
    if (t + 1 < n_t) {
      const int64_t o = at(t + 1);
      rn = to_f(r[o]);
      kn = to_f(k[o]);
      wn = to_f(w[o]);
      vn = to_f(v[o]);
    }
    if (SAVE) {
      float* dst = ws + (bh * n_t + t) * HD * HD + j;
#pragma unroll
      for (int i = 0; i < HD; ++i) dst[i * HD] = s[i];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = rnd<T>(__fmul_rn(sk[cur][i], vj));
      if (OUT) {
        const float m = rnd<T>(__fadd_rn(s[i], __fmul_rn(su[i], kv)));
        acc[i % 4] = fmaf(sr[cur][i], m, acc[i % 4]);
      }
      s[i] = __fadd_rn(__fmul_rn(sw[cur][i], s[i]), kv);
    }
    if (OUT) y[at(t)] = from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if (t + 1 < n_t) {
      sr[cur ^ 1][j] = rn;
      sk[cur ^ 1][j] = kn;
      sw[cur ^ 1][j] = wn;
      vj = vn;
    }
    __syncthreads();
  }
  if (OUT) {
#pragma unroll
    for (int i = 0; i < HD; ++i) s_out[(bh * HD + i) * HD + j] = s[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const T* __restrict__ u, const float* __restrict__ ws,
                 const T* __restrict__ dy, const float* __restrict__ ds,
                 T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                 T* __restrict__ dw, float* __restrict__ du,
                 float* __restrict__ ds0, int64_t n_t, int64_t n_h) {
  constexpr int kLanes = HD < 32 ? HD : 32;
  constexpr int kWarps = HD / kLanes;
  constexpr unsigned kMask = kLanes == 32 ? 0xffffffffu : (1u << kLanes) - 1;
  __shared__ float sr[2][HD], sk[2][HD], sw[2][HD], su[HD];
  // by step parity: the warps' partial sums of dr, dw, dk, du by row
  __shared__ float red[2][4][kWarps][HD];
  const int j = threadIdx.x, lane = j % 32, warp = j / 32;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / n_h, h = bh % n_h;
  const auto at = [&](int64_t t) { return ((b * n_t + t) * n_h + h) * HD + j; };
  float g[HD];  // the cotangent of the state's column j
#pragma unroll
  for (int i = 0; i < HD; ++i)
    g[i] = ds ? ds[(bh * HD + i) * HD + j] : 0.f;
  su[j] = to_f(u[h * HD + j]);
  {
    const int last = (n_t - 1) & 1;
    const int64_t o = at(n_t - 1);
    sr[last][j] = to_f(r[o]);
    sk[last][j] = to_f(k[o]);
    sw[last][j] = to_f(w[o]);
  }
  float vj = to_f(v[at(n_t - 1)]), dyj = to_f(dy[at(n_t - 1)]);
  float du_own = 0.f;  // du of row j, summed over time
  __syncthreads();
  for (int64_t t = n_t - 1; t >= 0; --t) {
    const int cur = t & 1;
    float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f, dyn = 0.f;
    if (t > 0) {
      const int64_t o = at(t - 1);
      rn = to_f(r[o]);
      kn = to_f(k[o]);
      wn = to_f(w[o]);
      vn = to_f(v[o]);
      dyn = to_f(dy[o]);
    }
    const float* sp = ws + (bh * n_t + t) * HD * HD + j;
    float dvj = 0.f;
#pragma unroll
    for (int g0 = 0; g0 < HD; g0 += 16) {
      float pr[16], pw[16], pk[16], pu[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int i = g0 + q;
        const float s = sp[i * HD];
        const float ki = sk[cur][i], ui = su[i];
        const float kv = rnd<T>(__fmul_rn(ki, vj));
        const float m = rnd<T>(__fadd_rn(s, __fmul_rn(ui, kv)));
        const float dm = sr[cur][i] * dyj;
        const float dkv = fmaf(ui, dm, g[i]);
        pr[q] = m * dyj;
        pw[q] = g[i] * s;
        pk[q] = dkv * vj;
        pu[q] = dm * kv;
        dvj = fmaf(dkv, ki, dvj);
        g[i] = fmaf(sw[cur][i], g[i], dm);
      }
      float sums[4] = {reduce_scatter<16>(pr, lane, kMask),
                       reduce_scatter<16>(pw, lane, kMask),
                       reduce_scatter<16>(pk, lane, kMask),
                       reduce_scatter<16>(pu, lane, kMask)};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (kLanes == 32) sums[x] += __shfl_xor_sync(kMask, sums[x], 16);
        if (lane < 16) red[cur][x][warp][g0 + lane] = sums[x];
      }
    }
    dv[at(t)] = from_f<T>(dvj);
    if (t > 0) {
      sr[cur ^ 1][j] = rn;
      sk[cur ^ 1][j] = kn;
      sw[cur ^ 1][j] = wn;
      vj = vn;
      dyj = dyn;
    }
    __syncthreads();
    // thread j now stands for row j
    float tot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) tot[x] += red[cur][x][wp][j];
    dr[at(t)] = from_f<T>(tot[0]);
    dw[at(t)] = from_f<T>(tot[1]);
    dk[at(t)] = from_f<T>(tot[2]);
    du_own += tot[3];
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) ds0[(bh * HD + i) * HD + j] = g[i];
  atomicAdd(du + h * HD + j, du_own);
}

template <typename T, int HD>
cudaError_t fwd(const void* r, const void* k, const void* v, const void* w,
                const void* u, const float* s0, void* y, float* s_out,
                int64_t n_b, int64_t n_t, int64_t n_h, cudaStream_t st) {
  rwkv6_fwd_kernel<T, HD, true, false><<<n_b * n_h, HD, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<T*>(y), s_out, nullptr, n_t,
      n_h);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t bwd(const void* r, const void* k, const void* v, const void* w,
                const void* u, const float* s0, const void* dy,
                const float* ds, float* ws, void* dr, void* dk, void* dv,
                void* dw, float* du, float* ds0, int64_t n_b, int64_t n_t,
                int64_t n_h, cudaStream_t st) {
  const T *rp = static_cast<const T*>(r), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *wp = static_cast<const T*>(w),
          *up = static_cast<const T*>(u);
  rwkv6_fwd_kernel<T, HD, false, true><<<n_b * n_h, HD, 0, st>>>(
      rp, kp, vp, wp, up, s0, nullptr, nullptr, ws, n_t, n_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rwkv6_bwd_kernel<T, HD><<<n_b * n_h, HD, 0, st>>>(
      rp, kp, vp, wp, up, ws, static_cast<const T*>(dy), ds,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), du, ds0, n_t, n_h);
  return cudaGetLastError();
}

template <typename T>
int fwd_hd(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int64_t n_b,
           int64_t n_t, int64_t n_h, int64_t hd, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s0f = static_cast<const float*>(s0);
  const auto sof = static_cast<float*>(s_out);
  if (n_b * n_h == 0) return 0;
  if (n_t < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return fwd<T, 16>(r, k, v, w, u, s0f, y, sof, n_b, n_t, n_h, st);
    case 32:
      return fwd<T, 32>(r, k, v, w, u, s0f, y, sof, n_b, n_t, n_h, st);
    case 64:
      return fwd<T, 64>(r, k, v, w, u, s0f, y, sof, n_b, n_t, n_h, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd_hd(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dy, const void* ds,
           void* ws, void* dr, void* dk, void* dv, void* dw, void* du,
           void* ds0, int64_t n_b, int64_t n_t, int64_t n_h, int64_t hd,
           void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto s0f = static_cast<const float*>(s0);
  const auto dsf = static_cast<const float*>(ds);
  const auto wsf = static_cast<float*>(ws);
  const auto duf = static_cast<float*>(du);
  const auto ds0f = static_cast<float*>(ds0);
  if (n_b * n_h == 0) return 0;
  if (n_t < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return bwd<T, 16>(r, k, v, w, u, s0f, dy, dsf, wsf, dr, dk, dv, dw, duf,
                        ds0f, n_b, n_t, n_h, st);
    case 32:
      return bwd<T, 32>(r, k, v, w, u, s0f, dy, dsf, wsf, dr, dk, dv, dw, duf,
                        ds0f, n_b, n_t, n_h, st);
    case 64:
      return bwd<T, 64>(r, k, v, w, u, s0f, dy, dsf, wsf, dr, dk, dv, dw, duf,
                        ds0f, n_b, n_t, n_h, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w, u, s0 (float32), y, s_out (float32); B, T, H, hd; stream
#define RWKV6_FWD(name, T)                                                   \
  extern "C" int name(const void* r, const void* k, const void* v,           \
                      const void* w, const void* u, const void* s0, void* y, \
                      void* s_out, int64_t n_b, int64_t n_t, int64_t n_h,    \
                      int64_t hd, void* stream) {                            \
    return fwd_hd<T>(r, k, v, w, u, s0, y, s_out, n_b, n_t, n_h, hd,         \
                     stream);                                                \
  }
RWKV6_FWD(rwkv6_scan_fwd_f32, float)
RWKV6_FWD(rwkv6_scan_fwd_bf16, bf16)

// r, k, v, w, u, s0, dy, ds (float32 or null), ws (float32 workspace of
// B*H*T*hd*hd); dr, dk, dv, dw, du (float32 (H, hd), zeroed), ds0;
// B, T, H, hd; stream
#define RWKV6_BWD(name, T)                                                   \
  extern "C" int name(const void* r, const void* k, const void* v,           \
                      const void* w, const void* u, const void* s0,          \
                      const void* dy, const void* ds, void* ws, void* dr,    \
                      void* dk, void* dv, void* dw, void* du, void* ds0,     \
                      int64_t n_b, int64_t n_t, int64_t n_h, int64_t hd,     \
                      void* stream) {                                        \
    return bwd_hd<T>(r, k, v, w, u, s0, dy, ds, ws, dr, dk, dv, dw, du, ds0, \
                     n_b, n_t, n_h, hd, stream);                             \
  }
RWKV6_BWD(rwkv6_scan_bwd_f32, float)
RWKV6_BWD(rwkv6_scan_bwd_bf16, bf16)
