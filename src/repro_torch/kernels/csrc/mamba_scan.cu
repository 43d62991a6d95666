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
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Sum V values p[0..V) over the lanes that differ in the low log2(V) lane
// bits (a butterfly reduce-scatter): the result is the sum of index
// lane % V.  V - 1 shuffles.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&p)[V], int lane) {
#pragma unroll
  for (int m = V / 2; m >= 1; m /= 2) {
    const bool hi = lane & m;
#pragma unroll
    for (int q = 0; q < m; ++q) {
      const float send = hi ? p[q] : p[q + m];
      const float keep = hi ? p[q + m] : p[q];
      p[q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return p[0];
}

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
