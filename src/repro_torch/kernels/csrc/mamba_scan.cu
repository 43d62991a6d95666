// mamba_scan: the Mamba selective-SSM recurrence over time, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the `jax.lax.scan` of `mamba_block` in src/repro/models/ssm.py
// (its `step`), which XLA compiles into one loop on the device.  No Pallas
// kernel computes it; the port's first version ran it as a Python loop of
// about ten launches a token (`ref.mamba_scan`, the plain version).
//
//   x_t     = delta_t u_t                      (rounded to the activations'
//                                               dtype)
//   s_t[n]  = exp(delta_t a[n]) s_{t-1}[n] + x_t B_t[n]     (float32)
//   y_t     = sum_n s_t[n] C_t[n]              (s_t rounded to C's dtype,
//                                               summed in f32, rounded once)
//
// u is (B, T, D), delta (B, T, 1), B and C (B, T, N), all in float32 or
// bfloat16; a (D, N) and the state (B, D, N) are float32.
//
// Forward: one thread per (batch, channel), holding the N = 16 state
// values and its row of a in registers; a block takes 128 channels of one
// batch row.  delta_t, B_t and C_t are the same for all of a row's
// channels, so the block stages them in shared memory 32 steps at a time,
// with the chunk's u.  exp is `expf` (not `__expf`), and __fmul_rn /
// __fadd_rn keep the plain version's separate roundings, so the state is
// bitwise the plain version's on the card.
//
// Backward: the forward runs again and writes s_t of every step into a
// float32 workspace (B * T * D * N * 4 bytes: 2.1 GB at Jamba's width,
// B = 2, T = 2048); then a second kernel walks time backward with the
// state's cotangent h in registers (s_{t-1} is loaded a step ahead):
//
//   h     += dy_t C_t                dC_t[n] += dy_t round(s_t[n])
//   dx     = sum_n h[n] B_t[n]       dB_t[n] += h[n] x_t
//   g[n]   = h[n] s_{t-1}[n] exp(delta_t a[n])
//   da[n] += g[n] delta_t            ddelta_t += sum_n g[n] a[n] + dx u_t
//   du_t   = dx delta_t              h[n]    = h[n] exp(delta_t a[n])
//
// dB, dC and ddelta sum over channels: a warp's 2N = 32 values go through a
// butterfly reduce-scatter of 31 shuffles (ddelta's one value 5 more), the
// warps meet in shared memory and each block adds its sums into float32
// accumulators with 33 atomic adds a step; da sums over time in registers
// and over the batch by atomic adds.  Gradients are float32 throughout
// and round once to the inputs' dtypes.
//
// Bound: 7 float32 operations a state value a step (an exp counted as
// one) on the CUDA cores (67 TFLOP/s): at Jamba prefill (B = 8, T = 512,
// D = 8192, N = 16) 3.8 GFLOP, 56 us, against 143 MB of inputs and
// outputs (43 us at 3.35 TB/s).  B * D / 128 blocks run (512 at Jamba
// prefill), each serial in T, so a step's latency sets the time.
//
// Two more forward routes (repro_torch.kernels.scan.mamba_plan picks one):
//
// `decode` (T = 1, float32 or bf16): the forward's arithmetic and roundings
// exactly, so the state is bitwise the plain version's, without the
// staging and its two barriers: two threads a channel each read 8 state
// values and 8 of its row of a as two 16-byte loads each, delta, B and C
// of its batch row straight from global memory (one address a warp), and
// write 8 state values as two 16-byte stores.  Bound: the state read and written and a read,
// 9.0 MB at Jamba decode (B = 8, D = 8192), 2.7 us at 3.35 TB/s.
//
// `chunk` (bf16, T >= 2; prefill): the forward's thread-per-channel scan
// with the arithmetic the card is fast at.  exp(delta a) is one
// `ex2.approx`, of 1 + delta (a log2 e) halved (`exp_neg`), a log2 e formed
// once a thread; the state update is one fused multiply-add, e s + x B;
// x = delta u stays float32; the read-out sums the float32 state times C
// in float32.  (The step kernel rounds x and the read-out's state to bf16,
// as the reference does; an output rounded from a bf16 state is as far
// from the float32 loop as the bf16 loop's, so the route could not be held
// below the bf16 loop's error with that rounding kept.)  u arrives and y
// leaves as 16-byte vectors through shared memory, 32 steps at a time, and
// B and C are staged as 16-byte vectors too.  The route no longer rounds
// as the loop does, so it is held to the plain loop run in float32 on the
// same bf16 values: no further from it than the bf16 loop is.  Bound: one
// ex2 a state value a step on the special-function units, 16 a clock on
// each SM: at Jamba prefill 5.37e8 exps, 128 us at 1.98 GHz on 132 SMs,
// above the 143 MB (42.7 us) of bytes; the step route's 56 us counted an
// exp as one float32 operation.
//
// The `chunk` backward route (the chunk forward route's inputs;
// `mamba_scan_bwd_chunk_bf16`, picked by scan.mamba_bwd_plan) replaces the
// step pair's workspace of every step's state (2.1 GB at Jamba's width,
// B = 2, T = 2048) and its walk over all T steps in B * D / 128 blocks:
//   1. `mamba_bound_kernel`, a thread per (batch, channel, quarter of the
//      state), walks the state forward and the cotangent back and keeps
//      both every 64 steps (67 MB at that shape);
//   2. `mamba_grad_kernel`, a block per (256 channels, unit of 64 steps,
//      batch), recomputes the unit's states from the one entering it and
//      walks back from the cotangent leaving it, the sums over channels
//      (dB, dC, ddelta) and over time (da) as per-block partial sums;
//   3. `colsum_kernel` reduces the partial sums in a fixed order: every
//      sum is the same from run to run, and nothing is added atomically.
// exp(delta a) is `exp_neg` throughout, x = delta u and the states float32.
// Bound: one exp a state value a step, 5.37e8 at that shape, 128 us on
// the special-function units, above the 206 MB of bytes (62 us).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "scan.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;

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
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Stage steps [t0, t0 + len) of delta, B and C (shared by the row) and
// the block's channels of `per_channel` into shared memory.
template <typename T, int N>
__device__ __forceinline__ void stage(const T* __restrict__ delta,
                                      const T* __restrict__ bm,
                                      const T* __restrict__ cm,
                                      const T* __restrict__ per_channel,
                                      float (&sdt)[kChunk],
                                      float (&sb)[kChunk][N],
                                      float (&sc)[kChunk][N],
                                      float (&sx)[kChunk][kThreads],
                                      int64_t b, int64_t t0, int len,
                                      int64_t n_t, int64_t n_d, int64_t d) {
  const int tid = threadIdx.x;
  for (int e = tid; e < len * N; e += kThreads) {
    const int c = e / N, n = e % N;
    const int64_t o = (b * n_t + t0 + c) * N + n;
    sb[c][n] = to_f(bm[o]);
    sc[c][n] = to_f(cm[o]);
  }
  for (int c = tid; c < len; c += kThreads) sdt[c] = to_f(delta[b * n_t + t0 + c]);
  if (d < n_d)
    for (int c = 0; c < len; ++c)
      sx[c][tid] = to_f(per_channel[(b * n_t + t0 + c) * n_d + d]);
}

// OUT: write y and the last state; SAVE: write s_t of every step into
// ws (B, T, D, N)
template <typename T, int N, bool OUT, bool SAVE>
__global__ void __launch_bounds__(kThreads)
mamba_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ a, const float* __restrict__ s0,
                 T* __restrict__ y, float* __restrict__ s_out,
                 float* __restrict__ ws, int64_t n_t, int64_t n_d) {
  __shared__ float sdt[kChunk], sb[kChunk][N], sc[kChunk][N];
  __shared__ float su[kChunk][kThreads];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y, d = blockIdx.x * int64_t{kThreads} + tid;
  const bool live = d < n_d;
  float s[N], an[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    s[n] = live ? s0[(b * n_d + d) * N + n] : 0.f;
    an[n] = live ? a[d * N + n] : 0.f;
  }
  for (int64_t t0 = 0; t0 < n_t; t0 += kChunk) {
    const int len = static_cast<int>(n_t - t0 < kChunk ? n_t - t0 : kChunk);
    __syncthreads();  // the last chunk's readers are done
    stage<T, N>(delta, bm, cm, u, sdt, sb, sc, su, b, t0, len, n_t, n_d, d);
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < len; ++c) {
      const float dt = sdt[c];
      const float x = rnd<T>(__fmul_rn(dt, su[c][tid]));
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float e = expf(__fmul_rn(dt, an[n]));
        s[n] = __fadd_rn(__fmul_rn(e, s[n]), __fmul_rn(x, sb[c][n]));
        if (OUT) acc = fmaf(rnd<T>(s[n]), sc[c][n], acc);
      }
      const int64_t row = (b * n_t + t0 + c) * n_d + d;
      if (SAVE) {
#pragma unroll
        for (int n = 0; n < N; ++n) ws[row * N + n] = s[n];
      }
      if (OUT) y[row] = from_f<T>(acc);
    }
  }
  if (OUT && live) {
#pragma unroll
    for (int n = 0; n < N; ++n) s_out[(b * n_d + d) * N + n] = s[n];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ a, const float* __restrict__ s0,
                 const float* __restrict__ ws, const T* __restrict__ dy,
                 const float* __restrict__ ds, T* __restrict__ du,
                 float* __restrict__ ddelta, float* __restrict__ dbm,
                 float* __restrict__ dcm, float* __restrict__ da,
                 float* __restrict__ ds0, int64_t n_t, int64_t n_d) {
  static_assert(2 * N == 32, "the reduce-scatter takes dB and dC as 32 values");
  __shared__ float sdt[kChunk], sb[kChunk][N], sc[kChunk][N];
  __shared__ float su[kChunk][kThreads], sdy[kChunk][kThreads];
  // by step parity: each warp's dC, dB (2N values) and ddelta
  __shared__ float red[2][kWarps][2 * N + 1];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = blockIdx.y, d = blockIdx.x * int64_t{kThreads} + tid;
  const bool live = d < n_d;
  float h[N], an[N], gacc[N], st[N], sp[N];
  const auto state = [&](int64_t t, int n) {  // s_t; s_{-1} is s0
    return t >= 0 ? ws[((b * n_t + t) * n_d + d) * N + n]
                  : s0[(b * n_d + d) * N + n];
  };
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = live && ds ? ds[(b * n_d + d) * N + n] : 0.f;
    an[n] = live ? a[d * N + n] : 0.f;
    gacc[n] = 0.f;
    st[n] = live ? state(n_t - 1, n) : 0.f;
    sp[n] = live ? state(n_t - 2, n) : 0.f;
  }
  for (int64_t t0 = ((n_t - 1) / kChunk) * kChunk; t0 >= 0; t0 -= kChunk) {
    const int len = static_cast<int>(n_t - t0 < kChunk ? n_t - t0 : kChunk);
    __syncthreads();
    stage<T, N>(delta, bm, cm, u, sdt, sb, sc, su, b, t0, len, n_t, n_d, d);
    if (live)
      for (int c = 0; c < len; ++c)
        sdy[c][tid] = to_f(dy[(b * n_t + t0 + c) * n_d + d]);
    __syncthreads();
    for (int c = len - 1; c >= 0; --c) {
      const int64_t t = t0 + c;
      const int par = t & 1;
      float p[2 * N], pdt = 0.f;
      if (live) {
        float nxt[N];  // s_{t-2}, for the next step
#pragma unroll
        for (int n = 0; n < N; ++n) nxt[n] = t >= 1 ? state(t - 2, n) : 0.f;
        const float dt = sdt[c], uv = su[c][tid], dyv = sdy[c][tid];
        const float x = rnd<T>(__fmul_rn(dt, uv));
        float dx = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(dyv, sc[c][n], h[n]);
          p[n] = dyv * rnd<T>(st[n]);
          dx = fmaf(h[n], sb[c][n], dx);
          p[N + n] = h[n] * x;
          const float e = expf(__fmul_rn(dt, an[n]));
          const float g = h[n] * sp[n] * e;
          gacc[n] = fmaf(g, dt, gacc[n]);
          pdt = fmaf(g, an[n], pdt);
          h[n] *= e;
        }
        pdt = fmaf(dx, uv, pdt);
        du[(b * n_t + t) * n_d + d] = from_f<T>(dx * dt);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          st[n] = sp[n];
          sp[n] = nxt[n];
        }
      } else {
#pragma unroll
        for (int n = 0; n < 2 * N; ++n) p[n] = 0.f;
      }
      const float mine = reduce_scatter<2 * N>(p, lane);
#pragma unroll
      for (int m = 16; m >= 1; m /= 2)
        pdt += __shfl_xor_sync(0xffffffffu, pdt, m);
      red[par][warp][lane] = mine;
      if (lane == 0) red[par][warp][2 * N] = pdt;
      __syncthreads();
      if (tid <= 2 * N) {
        float sum = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) sum += red[par][wp][tid];
        const int64_t bt = b * n_t + t;
        if (tid < N)
          atomicAdd(dcm + bt * N + tid, sum);
        else if (tid < 2 * N)
          atomicAdd(dbm + bt * N + tid - N, sum);
        else
          atomicAdd(ddelta + bt, sum);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      ds0[(b * n_d + d) * N + n] = h[n];
      atomicAdd(da + d * N + n, gacc[n]);
    }
  }
}

// N values of a row of T into float32, 16-byte loads (the row 16-byte
// aligned)
template <typename T, int N>
__device__ __forceinline__ void load_row(float (&out)[N],
                                         const T* __restrict__ p) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int n = 0; n < N; n += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + n);
      out[n] = f.x;
      out[n + 1] = f.y;
      out[n + 2] = f.z;
      out[n + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; n += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + n);
      const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 f = __bfloat1622float2(h[x]);
        out[n + 2 * x] = f.x;
        out[n + 2 * x + 1] = f.y;
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[N]) {
#pragma unroll
  for (int n = 0; n < N; n += 4)
    *reinterpret_cast<float4*>(p + n) =
        make_float4(v[n], v[n + 1], v[n + 2], v[n + 3]);
}

// The `decode` route: one step (T = 1), the forward's arithmetic.  Two
// threads a channel, adjacent lanes, each with half of its N state values:
// the exps and updates of the halves run side by side, and the read-out's
// sum runs through the low half, then on in the high half from the low
// half's partial sum (one shuffle), in the forward's order, so y is the
// forward's bit for bit too.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
mamba_decode_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ s_out,
                    int64_t n_d) {
  constexpr int H = N / 2;
  const int half = threadIdx.x & 1;
  const int64_t b = blockIdx.y;
  const int64_t d = blockIdx.x * int64_t{kThreads / 2} + threadIdx.x / 2;
  const bool live = d < n_d;  // the same for both halves of a channel
  float bv[H], cv[H], s[H], an[H];
  float acc = 0.f;
  if (live) {
    load_row<T, H>(bv, bm + b * N + half * H);
    load_row<T, H>(cv, cm + b * N + half * H);
    load_row<float, H>(s, s0 + (b * n_d + d) * N + half * H);
    load_row<float, H>(an, a + d * N + half * H);
    const float dt = to_f(delta[b]);
    const float x = rnd<T>(__fmul_rn(dt, to_f(u[b * n_d + d])));
#pragma unroll
    for (int n = 0; n < H; ++n) {
      const float e = expf(__fmul_rn(dt, an[n]));
      s[n] = __fadd_rn(__fmul_rn(e, s[n]), __fmul_rn(x, bv[n]));
    }
    if (!half) {
#pragma unroll
      for (int n = 0; n < H; ++n) acc = fmaf(rnd<T>(s[n]), cv[n], acc);
    }
  }
  acc = __shfl_up_sync(0xffffffffu, acc, 1);
  if (!live) return;
  if (half) {
#pragma unroll
    for (int n = 0; n < H; ++n) acc = fmaf(rnd<T>(s[n]), cv[n], acc);
    y[b * n_d + d] = from_f<T>(acc);
  }
  store_row<H>(s_out + (b * n_d + d) * N + half * H, s);
}

__device__ __forceinline__ float ex2(float x) {
  float out;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(out) : "f"(x));
  return out;
}

// exp(dt a) for dt a <= 0, given a2 = a log2 e: 2**(1 + dt a2) / 2, one
// ex2.approx.  The shift puts the exponent of a decay near 1 into [0, 1),
// where the special-function unit's result is `expf`'s (which reduces its
// argument into [0, 1) the same way); ex2.approx of the unshifted small
// exponent is biased by -2e-8 (relative, a third of an ulp), and that
// bias compounds over the steps a state near 1 remembers.
__device__ __forceinline__ float exp_neg(float dt, float a2) {
  return 0.5f * ex2(fmaf(dt, a2, 1.f));
}

// The `chunk` route: bf16 prefill, D a multiple of 8
template <int N>
__global__ void __launch_bounds__(kThreads)
mamba_chunk_kernel(const bf16* __restrict__ u, const bf16* __restrict__ delta,
                   const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                   const float* __restrict__ a, const float* __restrict__ s0,
                   bf16* __restrict__ y, float* __restrict__ s_out,
                   int64_t n_t, int64_t n_d) {
  static_assert(N % 8 == 0, "B and C rows are staged as 16-byte vectors");
  constexpr int kVec = kThreads / 8;  // 16-byte vectors of a step's u or y
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ float sdt[kChunk];
  __shared__ __align__(16) float sb[kChunk][N];
  __shared__ __align__(16) float sc[kChunk][N];
  // u and y of the chunk, bf16 bits
  __shared__ __align__(16) uint16_t su[kChunk][kThreads];
  __shared__ __align__(16) uint16_t sy[kChunk][kThreads];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y, d0 = blockIdx.x * int64_t{kThreads};
  const int64_t d = d0 + tid;
  const bool live = d < n_d;
  float s[N], a2[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = a2[n] = 0.f;
  if (live) {
    load_row<float, N>(s, s0 + (b * n_d + d) * N);
    load_row<float, N>(a2, a + d * N);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) a2[n] *= kLog2e;
  // y of the chunk at step t0 (len steps) from sy, 16 bytes a thread
  const auto flush = [&](int64_t t0, int len) {
    for (int e = tid; e < len * kVec; e += kThreads) {
      const int c = e / kVec, v = e % kVec;
      if (d0 + v * 8 < n_d)
        *reinterpret_cast<uint4*>(y + (b * n_t + t0 + c) * n_d + d0 + v * 8) =
            *reinterpret_cast<const uint4*>(&sy[c][v * 8]);
    }
  };
  for (int64_t t0 = 0; t0 < n_t; t0 += kChunk) {
    const int len = static_cast<int>(n_t - t0 < kChunk ? n_t - t0 : kChunk);
    __syncthreads();  // the last chunk's readers are done
    if (t0 > 0) flush(t0 - kChunk, kChunk);
    for (int e = tid; e < len * kVec; e += kThreads) {
      const int c = e / kVec, v = e % kVec;
      if (d0 + v * 8 < n_d)
        *reinterpret_cast<uint4*>(&su[c][v * 8]) =
            *reinterpret_cast<const uint4*>(u + (b * n_t + t0 + c) * n_d +
                                            d0 + v * 8);
    }
    for (int e = tid; e < 2 * len * (N / 8); e += kThreads) {
      const int which = e / (len * (N / 8)), f = e % (len * (N / 8));
      const int c = f / (N / 8), n = f % (N / 8) * 8;
      float vals[8];
      load_row<bf16, 8>(vals, (which ? cm : bm) + (b * n_t + t0 + c) * N + n);
      float* dst = which ? &sc[c][n] : &sb[c][n];
      *reinterpret_cast<float4*>(dst) =
          make_float4(vals[0], vals[1], vals[2], vals[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(vals[4], vals[5], vals[6], vals[7]);
    }
    for (int c = tid; c < len; c += kThreads)
      sdt[c] = to_f(delta[b * n_t + t0 + c]);
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < len; ++c) {
      const float dt = sdt[c];
      const float x = dt * to_f(__ushort_as_bfloat16(su[c][tid]));
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 2) {
        s[n] = fmaf(exp_neg(dt, a2[n]), s[n], x * sb[c][n]);
        s[n + 1] = fmaf(exp_neg(dt, a2[n + 1]), s[n + 1], x * sb[c][n + 1]);
        acc = fmaf(s[n], sc[c][n], acc);
        acc = fmaf(s[n + 1], sc[c][n + 1], acc);
      }
      sy[c][tid] = __bfloat16_as_ushort(__float2bfloat16(acc));
    }
  }
  __syncthreads();
  const int64_t last = (n_t - 1) / kChunk * kChunk;
  flush(last, static_cast<int>(n_t - last));
  if (live) store_row<N>(s_out + (b * n_d + d) * N, s);
}


// The `chunk` backward route: bf16 prefill, D a multiple of 8, every
// tensor 16-byte aligned (the chunk forward route's inputs).  Units of
// kUnitM steps; the arithmetic is the chunk forward's (x = delta u and the
// read-out's state in float32, exp(delta a) from `exp_neg`).  A thread
// holds kQ of a channel's N state values, so that its B and C arrive as
// one 16-byte load and the sums over the state values start in registers.
constexpr int kUnitM = 64;         // steps a unit: boundaries are kept
constexpr int kQ = 4;              // state values a thread
constexpr int kBndThreads = 256;   // pass 1: 64 channels x 4
constexpr int kGradThreads = 128;  // pass 2: 32 channels x 4
constexpr int kBlkCh = 256;        // channels a pass-2 block (8 groups)
constexpr int kSub = 8;            // steps between pass 2's checkpoints

// kQ float32 values from shared memory (16-byte aligned)
__device__ __forceinline__ void lds4(float (&out)[kQ], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

// kQ bf16 values (8-byte aligned bits) as float32
__device__ __forceinline__ void ld4_bf16(float (&out)[kQ], const uint16_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
}

// Pass 1, a thread per (batch, channel, quarter of the state), a block per
// 64 channels: blockIdx.z = 0 walks the state forward from s0 and writes
// the state entering every unit into ws_s; blockIdx.z = 1 walks the
// cotangent back from ds (or 0), h <- exp(delta_t a) (h + dy_t C_t),
// writes the cotangent leaving every unit into ws_g and the first
// state's gradient into ds0.  A step's exponential and operands do not
// depend on the carried values, so a thread's chains are one multiply-add
// a step each.  The block stages a unit's u (or dy) and B (or C) as bf16
// by cp.async, two buffers, the next unit's loading while this one is
// walked (delta through a register).
template <int N>
__global__ void __launch_bounds__(kBndThreads)
mamba_bound_kernel(const bf16* __restrict__ u, const bf16* __restrict__ delta,
                   const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                   const float* __restrict__ a, const float* __restrict__ s0,
                   const bf16* __restrict__ dy, const float* __restrict__ ds,
                   float* __restrict__ ws_s, float* __restrict__ ws_g,
                   float* __restrict__ ds0, int64_t n_t, int64_t n_d) {
  static_assert(N == 4 * kQ, "four threads a channel");
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kCh = kBndThreads / (N / kQ);  // channels a block
  constexpr int kVV = kCh / 8, kVW = N / 8;    // 16-byte vectors a step
  __shared__ float sdt[2][kUnitM];
  __shared__ __align__(16) uint16_t sv[2][kUnitM][kCh];
  __shared__ __align__(16) uint16_t sw[2][kUnitM][N];
  const int tid = threadIdx.x, q = tid % (N / kQ), dl = tid / (N / kQ);
  const int64_t b = blockIdx.y, d0 = blockIdx.x * int64_t{kCh}, d = d0 + dl;
  const bool live = d < n_d, fwd = blockIdx.z == 0;
  const int64_t n_u = (n_t + kUnitM - 1) / kUnitM;
  const bf16* vsrc = fwd ? u : dy;
  const bf16* wsrc = fwd ? bm : cm;
  const int64_t at = (b * n_d + d) * N + q * kQ;  // (b, d, quarter)
  // unit k's u (or dy) and B (or C) into buffer buf; rows past T and
  // channels past D are zeros
  const auto load = [&](int64_t k, int buf) {
    for (int e = tid; e < kUnitM * (kVV + kVW); e += kBndThreads) {
      const bool isv = e < kUnitM * kVV;
      const int f = isv ? e : e - kUnitM * kVV;
      const int c = isv ? f / kVV : f / kVW, x = (isv ? f % kVV : f % kVW) * 8;
      const int64_t t = k * kUnitM + c;
      const bool ok = t < n_t && (!isv || d0 + x < n_d);
      const int64_t row = b * n_t + (ok ? t : 0);
      cp_async16(isv ? &sv[buf][c][x] : &sw[buf][c][x],
                 isv ? vsrc + row * n_d + (ok ? d0 + x : 0)
                     : wsrc + row * N + x, ok);
    }
    cp_async_commit();
  };
  const auto fetch_dt = [&](int64_t k) {
    const int64_t t = k * kUnitM + tid;
    return tid < kUnitM && t < n_t ? to_f(delta[b * n_t + t]) : 0.f;
  };
  float a2[kQ], m[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    a2[j] = live ? a[d * N + q * kQ + j] * kLog2e : 0.f;
    m[j] = !live ? 0.f : fwd ? s0[at + j] : ds ? ds[at + j] : 0.f;
  }
  const int64_t first = fwd ? 0 : n_u - 1;
  load(first, 0);
  if (tid < kUnitM) sdt[0][tid] = fetch_dt(first);
  cp_async_wait_all();
  __syncthreads();
  for (int64_t it = 0; it < n_u; ++it) {
    const int64_t k = fwd ? it : n_u - 1 - it;
    const int buf = it & 1;
    const int len = static_cast<int>(n_t - k * kUnitM < kUnitM
                                         ? n_t - k * kUnitM : kUnitM);
    float dnext = 0.f;
    if (it + 1 < n_u) {
      load(fwd ? k + 1 : k - 1, buf ^ 1);
      dnext = fetch_dt(fwd ? k + 1 : k - 1);
    }
    if (live) {
      float* out = (fwd ? ws_s : ws_g) + ((b * n_u + k) * n_d + d) * N +
                   q * kQ;
#pragma unroll
      for (int j = 0; j < kQ; ++j) out[j] = m[j];
      if (fwd) {
#pragma unroll 4
        for (int c = 0; c < len; ++c) {
          const float dt = sdt[buf][c];
          const float x = dt * bfu(sv[buf][c][dl]);
          float w4[kQ];
          ld4_bf16(w4, &sw[buf][c][q * kQ]);
#pragma unroll
          for (int j = 0; j < kQ; ++j)
            m[j] = fmaf(exp_neg(dt, a2[j]), m[j], x * w4[j]);
        }
      } else {
#pragma unroll 4
        for (int c = len - 1; c >= 0; --c) {
          const float dt = sdt[buf][c];
          const float v = bfu(sv[buf][c][dl]);
          float w4[kQ];
          ld4_bf16(w4, &sw[buf][c][q * kQ]);
#pragma unroll
          for (int j = 0; j < kQ; ++j)
            m[j] = exp_neg(dt, a2[j]) * fmaf(v, w4[j], m[j]);
        }
      }
    }
    if (it + 1 < n_u && tid < kUnitM) sdt[buf ^ 1][tid] = dnext;
    cp_async_wait_all();
    __syncthreads();
  }
  if (!fwd && live) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) ds0[at + j] = m[j];
  }
}

// Pass 2, a block per (channel block of kBlkCh, unit, batch), a thread per
// (channel of a group of 32, quarter of the state): for each group in
// turn, the unit's states recomputed forward from the one entering it,
// kept every kSub steps, then, from the last kSub steps back, each
// stretch recomputed from its checkpoint into registers and walked back
// from the cotangent, as the step kernel's backward walks.  The sums over
// a channel's state values (dx, and sum_n g a for ddelta) start in the
// thread and end in two shuffles over its four lanes; those over the
// warp's eight channels (dB and dC, 32 values, and ddelta) go through a
// reduce-scatter of three levels, one value a lane; each warp adds them
// into its own slot of shared memory (no atomics).  At the end the block
// writes its sums over its channels, and each thread its da over the
// unit, as partial sums that colsum_kernel reduces in a fixed order.
constexpr int kGradCh = kGradThreads / 4;  // channels a pass-2 group

// pass 2's shared memory (above the 48 KB of a static allocation)
template <int N>
struct GradSm {
  float sdt[kUnitM];
  float sb[kUnitM][N], sc[kUnitM][N];  // B and C of the unit
  // u, dy and du of a group (bf16 bits)
  uint16_t su[kUnitM][kGradCh], sdy[kUnitM][kGradCh], sdu[kUnitM][kGradCh];
  float acc[kGradThreads / 32][kUnitM][2 * N + 1];  // a slot a warp
};

template <int N>
__global__ void __launch_bounds__(kGradThreads)
mamba_grad_kernel(const bf16* __restrict__ u, const bf16* __restrict__ delta,
                  const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                  const float* __restrict__ a, const bf16* __restrict__ dy,
                  const float* __restrict__ ws_s,
                  const float* __restrict__ ws_g, bf16* __restrict__ du,
                  float* __restrict__ part, float* __restrict__ da_ws,
                  int64_t n_t, int64_t n_d) {
  static_assert(N == 4 * kQ, "four lanes a channel, eight channels a warp");
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kWarpsG = kGradThreads / 32;
  constexpr int kS = 2 * N + 1;  // dB, dC (N each) and ddelta a step
  constexpr int kCh = kGradCh;
  constexpr int kNSub = kUnitM / kSub;
  static_assert(kCh == kGradThreads / (N / kQ), "a group's channels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSm<N>& sm = *reinterpret_cast<GradSm<N>*>(smem_raw);
  auto& sdt = sm.sdt;
  auto& sb = sm.sb;
  auto& sc = sm.sc;
  auto& su = sm.su;
  auto& sdy = sm.sdy;
  auto& sdu = sm.sdu;
  auto& acc = sm.acc;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = tid % (N / kQ), dl = tid / (N / kQ);
  // the (dB or dC, state value) whose sum over the warp's channels this
  // lane ends with
  const int slot = (lane >> 4) * N + q * kQ + ((lane >> 2) & 3);
  const int64_t b = blockIdx.z, unit = blockIdx.y;
  const int64_t n_u = (n_t + kUnitM - 1) / kUnitM;
  const int64_t t0 = unit * kUnitM;
  const int len = static_cast<int>(n_t - t0 < kUnitM ? n_t - t0 : kUnitM);
  for (int e = tid; e < kWarpsG * kUnitM * kS; e += kGradThreads)
    (&acc[0][0][0])[e] = 0.f;
  for (int c = tid; c < kUnitM; c += kGradThreads)
    sdt[c] = c < len ? to_f(delta[b * n_t + t0 + c]) : 0.f;
  for (int e = tid; e < 2 * len * (N / 8); e += kGradThreads) {
    const int which = e / (len * (N / 8)), f = e % (len * (N / 8));
    const int c = f / (N / 8), x = f % (N / 8) * 8;
    float vals[8];
    load_row<bf16, 8>(vals, (which ? cm : bm) + (b * n_t + t0 + c) * N + x);
#pragma unroll
    for (int y = 0; y < 8; ++y) (which ? sc : sb)[c][x + y] = vals[y];
  }
  for (int64_t d0 = blockIdx.x * int64_t{kBlkCh};
       d0 < n_d && d0 < (blockIdx.x + 1) * int64_t{kBlkCh}; d0 += kCh) {
    const int64_t d = d0 + dl;
    const bool live = d < n_d;
    __syncthreads();  // the last group's readers are done
    for (int e = tid; e < 2 * len * (kCh / 8); e += kGradThreads) {
      const int which = e / (len * (kCh / 8)), f = e % (len * (kCh / 8));
      const int c = f / (kCh / 8), x = f % (kCh / 8) * 8;
      const bool ok = d0 + x < n_d;
      cp_async16(&(which ? sdy : su)[c][x],
                 (which ? dy : u) + (b * n_t + t0 + c) * n_d + (ok ? d0 + x : 0),
                 ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const int64_t at = ((b * n_u + unit) * n_d + d) * N + q * kQ;
    float an[kQ], a2[kQ], s[kQ], h[kQ], da[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      an[j] = live ? a[d * N + q * kQ + j] : 0.f;
      a2[j] = an[j] * kLog2e;
      s[j] = live ? ws_s[at + j] : 0.f;
      h[j] = live ? ws_g[at + j] : 0.f;
      da[j] = 0.f;
    }
    // one step forward: s_{t-1} -> s_t
    const auto step = [&](float (&v)[kQ], int c) {
      const float dt = sdt[c], x = dt * bfu(su[c][dl]);
      float bv[kQ];
      lds4(bv, &sb[c][q * kQ]);
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        v[j] = fmaf(exp_neg(dt, a2[j]), v[j], x * bv[j]);
    };
    // branch-free for a whole unit (so that the compiler can interleave
    // steps), guarded step by step for the last, short one
    const auto walk = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      float ck[kNSub][kQ];  // the state entering every kSub steps
#pragma unroll
      for (int k = 0; k < kNSub; ++k) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) ck[k][j] = s[j];
#pragma unroll
        for (int c = k * kSub; c < (k + 1) * kSub; ++c)
          if (kWhole || c < len) step(s, c);
      }
#pragma unroll
      for (int k = kNSub - 1; k >= 0; --k) {
        if (!kWhole && k * kSub >= len) continue;
        float sp[kSub][kQ];  // s_{t-1} of the stretch's steps
#pragma unroll
        for (int c = 0; c < kSub; ++c) {
#pragma unroll
          for (int j = 0; j < kQ; ++j) sp[c][j] = c ? sp[c - 1][j] : ck[k][j];
          if (c && (kWhole || k * kSub + c - 1 < len))
            step(sp[c], k * kSub + c - 1);
        }
#pragma unroll
        for (int c8 = kSub - 1; c8 >= 0; --c8) {
          const int c = k * kSub + c8;
          if (!kWhole && c >= len) continue;
          const float dt = sdt[c], uv = bfu(su[c][dl]), dyv = bfu(sdy[c][dl]);
          const float x = dt * uv;
          float bv[kQ], cv[kQ], p[2 * kQ];
          lds4(bv, &sb[c][q * kQ]);
          lds4(cv, &sc[c][q * kQ]);
          float dx = 0.f, ga = 0.f;
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const float e = exp_neg(dt, a2[j]);
            const float s_t = fmaf(e, sp[c8][j], x * bv[j]);
            h[j] = fmaf(dyv, cv[j], h[j]);  // dL/ds_t
            p[kQ + j] = dyv * s_t;          // dC
            p[j] = h[j] * x;                // dB
            dx = fmaf(h[j], bv[j], dx);
            const float g = h[j] * sp[c8][j] * e;
            da[j] = fmaf(g, dt, da[j]);
            ga = fmaf(g, an[j], ga);
            h[j] *= e;
          }
          // dx (lanes q < 2) and sum_n g a (q >= 2) over the channel's
          // four lanes
          const bool hi2 = lane & 2;
          float v = sel(hi2, ga, dx) +
                    __shfl_xor_sync(0xffffffffu, sel(hi2, dx, ga), 2);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          const float other = __shfl_xor_sync(0xffffffffu, v, 2);
          // on lane q = 0: dx = v, du = dx dt, ddelta's share other + dx u
          if (q == 0) sdu[c][dl] = __bfloat16_as_ushort(__float2bfloat16(v * dt));
          float dd = sel(q == 0, fmaf(v, uv, other), 0.f);
          dd += __shfl_xor_sync(0xffffffffu, dd, 4);
          dd += __shfl_xor_sync(0xffffffffu, dd, 8);
          dd += __shfl_xor_sync(0xffffffffu, dd, 16);
          // dB and dC over the warp's eight channels (lane bits 2-4): a
          // reduce-scatter, one of the 32 sums a lane
          {
            const bool hi = lane & 16;
#pragma unroll
            for (int x4 = 0; x4 < 4; ++x4) {
              const float send = sel(hi, p[x4], p[x4 + 4]);
              const float keep = sel(hi, p[x4 + 4], p[x4]);
              p[x4] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
            }
          }
          {
            const bool hi = lane & 8;
#pragma unroll
            for (int x2 = 0; x2 < 2; ++x2) {
              const float send = sel(hi, p[x2], p[x2 + 2]);
              const float keep = sel(hi, p[x2 + 2], p[x2]);
              p[x2] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
            }
          }
          {
            const bool hi = lane & 4;
            const float send = sel(hi, p[0], p[1]);
            const float keep = sel(hi, p[1], p[0]);
            p[0] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
          }
          acc[warp][c][slot] += p[0];
          if (lane == 0) acc[warp][c][2 * N] += dd;
        }
      }
    };
    if (len == kUnitM) {
      walk(std::true_type{});
    } else {
      walk(std::false_type{});
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) da_ws[at + j] = da[j];
    }
    __syncthreads();  // sdu written
    for (int e = tid; e < len * (kCh / 8); e += kGradThreads) {
      const int c = e / (kCh / 8), x = e % (kCh / 8) * 8;
      if (d0 + x < n_d)
        *reinterpret_cast<uint4*>(du + (b * n_t + t0 + c) * n_d + d0 + x) =
            *reinterpret_cast<const uint4*>(&sdu[c][x]);
    }
  }
  __syncthreads();
  const int64_t n_bt = gridDim.z * n_t;
  for (int e = tid; e < len * kS; e += kGradThreads) {
    const int c = e / kS, x = e % kS;
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarpsG; ++wp) sum += acc[wp][c][x];
    part[(blockIdx.x * n_bt + b * n_t + t0 + c) * kS + x] = sum;
  }
}

template <typename T>
int fwd(const void* u, const void* delta, const void* bm, const void* cm,
        const void* a, const void* s0, void* y, void* s_out, int64_t n_b,
        int64_t n_t, int64_t n_d, int64_t n_s, void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_t < 1 || n_s != 16) return cudaErrorInvalidValue;
  const dim3 grid((n_d + kThreads - 1) / kThreads, n_b);
  mamba_fwd_kernel<T, 16, true, false>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const T*>(delta),
          static_cast<const T*>(bm), static_cast<const T*>(cm),
          static_cast<const float*>(a), static_cast<const float*>(s0),
          static_cast<T*>(y), static_cast<float*>(s_out), nullptr, n_t, n_d);
  return cudaGetLastError();
}

template <typename T>
int bwd(const void* u, const void* delta, const void* bm, const void* cm,
        const void* a, const void* s0, const void* dy, const void* ds,
        void* ws, void* du, void* ddelta, void* dbm, void* dcm, void* da,
        void* ds0, int64_t n_b, int64_t n_t, int64_t n_d, int64_t n_s,
        void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_t < 1 || n_s != 16) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_d + kThreads - 1) / kThreads, n_b);
  const T *up = static_cast<const T*>(u), *dp = static_cast<const T*>(delta),
          *bp = static_cast<const T*>(bm), *cp = static_cast<const T*>(cm);
  const auto ap = static_cast<const float*>(a);
  const auto s0p = static_cast<const float*>(s0);
  const auto wsp = static_cast<float*>(ws);
  mamba_fwd_kernel<T, 16, false, true><<<grid, kThreads, 0, st>>>(
      up, dp, bp, cp, ap, s0p, nullptr, nullptr, wsp, n_t, n_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mamba_bwd_kernel<T, 16><<<grid, kThreads, 0, st>>>(
      up, dp, bp, cp, ap, s0p, wsp, static_cast<const T*>(dy),
      static_cast<const float*>(ds), static_cast<T*>(du),
      static_cast<float*>(ddelta), static_cast<float*>(dbm),
      static_cast<float*>(dcm), static_cast<float*>(da),
      static_cast<float*>(ds0), n_t, n_d);
  return cudaGetLastError();
}

template <typename T>
int decode(const void* u, const void* delta, const void* bm, const void* cm,
           const void* a, const void* s0, void* y, void* s_out, int64_t n_b,
           int64_t n_d, int64_t n_s, void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_s != 16) return cudaErrorInvalidValue;
  const dim3 grid((n_d + kThreads / 2 - 1) / (kThreads / 2), n_b);
  mamba_decode_kernel<T, 16>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const T*>(delta),
          static_cast<const T*>(bm), static_cast<const T*>(cm),
          static_cast<const float*>(a), static_cast<const float*>(s0),
          static_cast<T*>(y), static_cast<float*>(s_out), n_d);
  return cudaGetLastError();
}


int chunk_bwd(const void* u, const void* delta, const void* bm, const void* cm,
              const void* a, const void* s0, const void* dy, const void* ds,
              void* ws, void* du, void* sums, void* da, void* ds0,
              int64_t n_b, int64_t n_t, int64_t n_d, int64_t n_s,
              void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_t < 1 || n_s != 16 || n_d % 8) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto up = static_cast<const bf16*>(u);
  const auto dp = static_cast<const bf16*>(delta);
  const auto bp = static_cast<const bf16*>(bm);
  const auto cp = static_cast<const bf16*>(cm);
  const auto ap = static_cast<const float*>(a);
  const auto dyp = static_cast<const bf16*>(dy);
  const int64_t n_u = (n_t + kUnitM - 1) / kUnitM;
  const int64_t n_blk = (n_d + kBlkCh - 1) / kBlkCh;
  const int64_t m = n_b * n_u * n_d * n_s;
  float* ws_s = static_cast<float*>(ws);
  float* ws_g = ws_s + m;
  float* da_ws = ws_g + m;
  float* part = da_ws + m;
  constexpr int kCh = kBndThreads / (16 / kQ);
  mamba_bound_kernel<16>
      <<<dim3((n_d + kCh - 1) / kCh, n_b, 2), kBndThreads, 0, st>>>(
          up, dp, bp, cp, ap, static_cast<const float*>(s0), dyp,
          static_cast<const float*>(ds), ws_s, ws_g, static_cast<float*>(ds0),
          n_t, n_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(GradSm<16>));
  err = cudaFuncSetAttribute(mamba_grad_kernel<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  mamba_grad_kernel<16><<<dim3(n_blk, n_u, n_b), kGradThreads, smem, st>>>(
      up, dp, bp, cp, ap, dyp, ws_s, ws_g, static_cast<bf16*>(du), part,
      da_ws, n_t, n_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t cols = n_b * n_t * (2 * 16 + 1);
  colsum_kernel<<<(cols + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(sums), n_blk, cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<<<(n_d * n_s + 255) / 256, 256, 0, st>>>(
      da_ws, static_cast<float*>(da), n_b * n_u, n_d * n_s);
  return cudaGetLastError();
}

}  // namespace

// u, delta, B, C, a (float32), s0 (float32), y, s_out (float32);
// batch, T, D, N; stream
#define MAMBA_FWD(name, T)                                                    \
  extern "C" int name(const void* u, const void* delta, const void* bm,       \
                      const void* cm, const void* a, const void* s0, void* y, \
                      void* s_out, int64_t n_b, int64_t n_t, int64_t n_d,     \
                      int64_t n_s, void* stream) {                            \
    return fwd<T>(u, delta, bm, cm, a, s0, y, s_out, n_b, n_t, n_d, n_s,      \
                  stream);                                                    \
  }
MAMBA_FWD(mamba_scan_fwd_f32, float)
MAMBA_FWD(mamba_scan_fwd_bf16, bf16)

// u, delta, B, C, a, s0, dy, ds (float32 or null), ws (float32 workspace of
// batch*T*D*N); du, then float32 accumulators, zeroed: ddelta (batch, T),
// dB, dC (batch, T, N), da (D, N); ds0; batch, T, D, N; stream
#define MAMBA_BWD(name, T)                                                    \
  extern "C" int name(const void* u, const void* delta, const void* bm,       \
                      const void* cm, const void* a, const void* s0,          \
                      const void* dy, const void* ds, void* ws, void* du,     \
                      void* ddelta, void* dbm, void* dcm, void* da,           \
                      void* ds0, int64_t n_b, int64_t n_t, int64_t n_d,       \
                      int64_t n_s, void* stream) {                            \
    return bwd<T>(u, delta, bm, cm, a, s0, dy, ds, ws, du, ddelta, dbm, dcm,  \
                  da, ds0, n_b, n_t, n_d, n_s, stream);                       \
  }
MAMBA_BWD(mamba_scan_bwd_f32, float)
MAMBA_BWD(mamba_scan_bwd_bf16, bf16)

// T = 1: u, delta, B, C, a (float32), s0 (float32), y, s_out (float32);
// batch, D, N; stream.  a, s0, s_out, B and C 16-byte aligned.
#define MAMBA_DECODE(name, T)                                                 \
  extern "C" int name(const void* u, const void* delta, const void* bm,       \
                      const void* cm, const void* a, const void* s0, void* y, \
                      void* s_out, int64_t n_b, int64_t n_d, int64_t n_s,     \
                      void* stream) {                                         \
    return decode<T>(u, delta, bm, cm, a, s0, y, s_out, n_b, n_d, n_s,        \
                     stream);                                                 \
  }
MAMBA_DECODE(mamba_scan_decode_f32, float)
MAMBA_DECODE(mamba_scan_decode_bf16, bf16)

// bf16: u, delta, B, C, a (float32), s0 (float32), y, s_out (float32);
// batch, T, D (a multiple of 8), N; stream.  Every tensor 16-byte aligned.
extern "C" int mamba_scan_chunk_bf16(const void* u, const void* delta,
                                     const void* bm, const void* cm,
                                     const void* a, const void* s0, void* y,
                                     void* s_out, int64_t n_b, int64_t n_t,
                                     int64_t n_d, int64_t n_s, void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_t < 1 || n_s != 16 || n_d % 8) return cudaErrorInvalidValue;
  const dim3 grid((n_d + kThreads - 1) / kThreads, n_b);
  mamba_chunk_kernel<16>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(u), static_cast<const bf16*>(delta),
          static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
          static_cast<const float*>(a), static_cast<const float*>(s0),
          static_cast<bf16*>(y), static_cast<float*>(s_out), n_t, n_d);
  return cudaGetLastError();
}

// the chunk backward route, bf16: u, delta, B, C, a (float32), s0
// (float32), dy, ds (float32 or null), ws (float32: 3 * batch *
// ceil(T / 64) * D * N + ceil(D / 256) * batch * T * (2N + 1)); du, sums
// (float32 (batch, T, 2N + 1): dB, dC, ddelta), da (float32 (D, N)), ds0
// (float32); batch, T, D (a multiple of 8), N; stream.  Every tensor
// 16-byte aligned.
extern "C" int mamba_scan_bwd_chunk_bf16(
    const void* u, const void* delta, const void* bm, const void* cm,
    const void* a, const void* s0, const void* dy, const void* ds, void* ws,
    void* du, void* sums, void* da, void* ds0, int64_t n_b, int64_t n_t,
    int64_t n_d, int64_t n_s, void* stream) {
  return chunk_bwd(u, delta, bm, cm, a, s0, dy, ds, ws, du, sums, da, ds0,
                   n_b, n_t, n_d, n_s, stream);
}
