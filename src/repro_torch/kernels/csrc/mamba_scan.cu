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
// Forward (the `step` route: T >= 2 off the vector width or unaligned, and
// T = 1 unaligned): one thread per (batch, channel), holding the N = 16
// state values and its row of a in registers; a block takes 128 channels
// of one batch row.  delta_t, B_t and C_t are the same for all of a row's
// channels, so the block stages them in shared memory 16 steps at a time,
// with the run's u, the next run loading into registers while this one is
// walked; the state and a arrive (and the last state leaves) through
// shared memory in coalesced rows.  exp is `expf` (not `__expf`), and
// __fmul_rn / __fadd_rn keep the plain version's separate roundings, so
// the state is bitwise the plain version's on the card; the read-out is
// one fused multiply-add chain over n (`ref.mamba_scan_step`).
//
// Backward (the `step` pair, for what the chunk route refuses: T = 1,
// widths off the 16-byte vector, unaligned tensors), parallel in T, with
// no workspace of every step's state: the chunk backward route's passes
// (below) with this forward's arithmetic.  The state's walk forward needs
// no cotangent and the cotangent's walk back, h <- exp(delta_t a) (h +
// dy_t C_t), needs no state, and every (channel, n) walks alone, so
// `mamba_step_bound_kernel` walks both side by side (a thread per
// channel and quarter of the state) and keeps the state entering and the
// cotangent leaving every unit of 32 steps (with the partial sums 0.219
// GB at Jamba's width, B = 2, T = 2048, where every step's state would
// be 2.1 GB); then `mamba_step_grad_kernel`, a block per
// (256 channels, unit, batch row), rebuilds each unit's states from the
// one entering it, bit for bit the loop's, and walks them back from the
// cotangent leaving it:
//
//   h     += dy_t C_t                dC_t[n] += dy_t round(s_t[n])
//   dx     = sum_n h[n] B_t[n]       dB_t[n] += h[n] x_t
//   g[n]   = h[n] s_{t-1}[n] exp(delta_t a[n])
//   da[n] += g[n] delta_t            ddelta_t += sum_n g[n] a[n] + dx u_t
//   du_t   = dx delta_t              h[n]    = h[n] exp(delta_t a[n])
//
// dB, dC and ddelta sum over channels through shuffles into a warp's slot
// of shared memory, then per block; da over the unit in registers; the
// partial sums meet in colsum_kernel in a fixed order.  Nothing is added
// atomically, so two runs give the same gradients bit for bit.
// Gradients are float32 throughout and round once to the inputs' dtypes.
//
// Bound: one exp a state value a step on the special-function units (16
// a clock an SM): at Jamba prefill (B = 8, T = 512, D = 8192, N = 16)
// 5.37e8 exps, 128 us at 1.98 GHz, above the 7 float32 operations a
// state value a step counted as one each (3.8 GFLOP, 56 us) and the 143
// MB of inputs and outputs (43 us at 3.35 TB/s).  The loop's roundings
// allow no fused update and no `ex2.approx`: `expf` alone is eight
// instructions, and the step's loop takes about 14.4 a state value a
// step (16.2 in bf16; chip_smoke.py's [build] counts them), 231 us at
// 132 SMs x 128 lanes x 1.98 GHz.  The
// backward: 22 operations a state value a step (the reverse step's and
// the recomputed state's), at B = 2, T = 2048, D = 8192 11.8 GFLOP,
// 176 us; the step pair's passes walk the state three times more (the
// boundary pass, the checkpoints, the stretches) and the cotangent once,
// each walk an expf a state value a step.
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
// `chunk` (T >= 2, prefill and training, float32 with D a multiple of 4 or
// bf16 with D a multiple of 8: `mamba_scan_chunk_f32` / `_bf16`): the
// forward's thread-per-channel scan with the arithmetic the card is fast
// at.  exp(delta a) is one
// `ex2.approx`, of 1 + delta (a log2 e) halved (`exp_neg`), a log2 e formed
// once a thread, the halving folded into powers of two that scale the
// state inside a chunk (bit for bit `exp_neg`'s state); the state update
// is one fused multiply-add, e s + x B; x = delta u stays float32; the
// read-out sums the float32 state times C in float32, in two chains.
// (The step kernel rounds x and the
// read-out's state to bf16, as the reference does; an output rounded from
// a bf16 state is as far from the float32 loop as the bf16 loop's, so the
// route could not be held below the bf16 loop's error with that rounding
// kept.)  u arrives by cp.async and y leaves as 16-byte vectors through
// shared memory, 32 steps at a time, the next chunk's u loading while
// this one is walked; B and C are staged as 16-byte vectors too.  The
// route no longer rounds as the loop does: in bf16 it is held to the plain
// loop run in float32 on the same values, no further from it than the
// bf16 loop is; in float32 to the float32 loop at 1e-5 of the largest
// state and y.  `ex2.approx` stays in float32 too: with it the route
// meets those tolerances in all three decay regimes up to T = 2048 at
// Jamba's width (chip_smoke.py's [scan] prints the errors beside the
// float32 loop's own against the loop in float64), so float32 needs no
// `expf`.  Bound: one ex2 a state value
// a step on the special-function units, 16 a clock on each SM: at Jamba
// prefill 5.37e8 exps, 128 us at 1.98 GHz on 132 SMs, above the bytes
// (143 MB, 42.8 us, in bf16; 278 MB, 83.0 us, in float32); the step
// route's 56 us counted an exp as one float32 operation.
//
// The `chunk` backward route (the chunk forward route's inputs;
// `mamba_scan_bwd_chunk_f32` / `_bf16`, picked by scan.mamba_bwd_plan),
// parallel in T in three launches (the step pair runs the same passes
// with the step forward's arithmetic and scalar loads):
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
// the special-function units, above the bytes (206 MB, 62 us, in bf16;
// 408 MB, 122 us, in float32).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "scan.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;
constexpr int kChunk = 32;

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

constexpr int kStepRun = 16;  // steps the step forward stages at a time

// The step forward's shared memory (static, 40.1 KB): a run's u, delta,
// B and C (two buffers), and the block's rows of s0 and a (rows padded to
// N + 4 floats: a quarter-warp's 16-byte loads of eight rows fall in
// distinct banks), whose first buffer takes the last state on its way
// out
template <int N>
struct StepSm {
  float su[2][kStepRun][kThreads];
  float sb[2][kStepRun][N], sc[2][kStepRun][N];
  float sdt[2][kStepRun];
  float rows[2][kThreads][N + 4];
};

// The step forward (T >= 1, any width and alignment), a thread a channel,
// 128 channels of one batch row a block.  The state and a arrive through
// shared memory from coalesced scalar loads (and the last state leaves so);
// the steps' u, delta, B and C are staged kStepRun at a time, the next run
// loading into registers by scalar loads while this one is walked, one
// barrier a run; B and C are read as 16-byte broadcasts.  Two steps an
// iteration, so that one step's read-out chain runs beside the next step's
// exponentials.  The arithmetic is the loop's: `expf`, x = delta u rounded
// to T, the update's separate roundings (the state bitwise the loop's),
// and the read-out one fused multiply-add chain over n = 0 .. N - 1 from 0,
// the order mamba_decode_kernel keeps (ref.mamba_scan_step sums so too).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 4)
mamba_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ a, const float* __restrict__ s0,
                 T* __restrict__ y, float* __restrict__ s_out, int64_t n_t,
                 int64_t n_d) {
  constexpr int kLw = 2 * kStepRun * N / kThreads;  // B and C a thread
  static_assert(kStepRun <= kThreads && N % 4 == 0, "a thread a step's delta");
  __shared__ __align__(16) StepSm<N> sm;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y, d0 = blockIdx.x * int64_t{kThreads};
  const int64_t d = d0 + tid;
  const bool live = d < n_d;
  const int n_live = static_cast<int>(n_d - d0 < kThreads ? n_d - d0
                                                          : kThreads);
  const int64_t n_c = (n_t + kStepRun - 1) / kStepRun;
  float pu[kStepRun], pw[kLw], pdt;  // the next run; past T and D zeros
  const auto fetch = [&](int64_t c) {
#pragma unroll
    for (int i = 0; i < kStepRun; ++i) {
      const int64_t t = c * kStepRun + i;
      pu[i] = t < n_t && live ? to_f(u[(b * n_t + t) * n_d + d]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLw; ++i) {
      const int e = tid + i * kThreads, which = e / (kStepRun * N);
      const int64_t t = c * kStepRun + e / N % kStepRun;
      pw[i] = t < n_t ? to_f((which ? cm : bm)[(b * n_t + t) * N + e % N])
                      : 0.f;
    }
    const int64_t t = c * kStepRun + tid;
    pdt = tid < kStepRun && t < n_t ? to_f(delta[b * n_t + t]) : 0.f;
  };
  const auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kStepRun; ++i) sm.su[buf][i][tid] = pu[i];
#pragma unroll
    for (int i = 0; i < kLw; ++i) {
      const int e = tid + i * kThreads, which = e / (kStepRun * N);
      (which ? sm.sc : sm.sb)[buf][e / N % kStepRun][e % N] = pw[i];
    }
    if (tid < kStepRun) sm.sdt[buf][tid] = pdt;
  };
  fetch(0);
  // the block's rows of s0 and a, coalesced
  for (int e = tid; e < n_live * N; e += kThreads) {
    sm.rows[0][e / N][e % N] = s0[(b * n_d + d0) * N + e];
    sm.rows[1][e / N][e % N] = a[d0 * N + e];
  }
  put(0);
  __syncthreads();
  float s[N], an[N];
  load_row<float, N>(s, &sm.rows[0][tid][0]);
  load_row<float, N>(an, &sm.rows[1][tid][0]);
  T* yp = y + b * n_t * n_d + d;
  // step c of buffer buf: the state forward, y out
  const auto step = [&](int buf, int c) {
    const float dt = sm.sdt[buf][c];
    const float x = rnd<T>(__fmul_rn(dt, sm.su[buf][c][tid]));
    float bv[N], cv[N];
    load_row<float, N>(bv, &sm.sb[buf][c][0]);
    load_row<float, N>(cv, &sm.sc[buf][c][0]);
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      const float e0 = expf(__fmul_rn(dt, an[n]));
      const float e1 = expf(__fmul_rn(dt, an[n + 1]));
      s[n] = __fadd_rn(__fmul_rn(e0, s[n]), __fmul_rn(x, bv[n]));
      s[n + 1] = __fadd_rn(__fmul_rn(e1, s[n + 1]), __fmul_rn(x, bv[n + 1]));
      float r0 = s[n], r1 = s[n + 1];
      rnd2<T>(r0, r1);
      acc = fmaf(r0, cv[n], acc);
      acc = fmaf(r1, cv[n + 1], acc);
    }
    if (live) *yp = from_f<T>(acc);
    yp += n_d;
  };
  for (int64_t c = 0; c < n_c; ++c) {
    const int buf = static_cast<int>(c & 1);
    if (c + 1 < n_c) fetch(c + 1);
    if (c + 1 < n_c || n_t % kStepRun == 0) {
#pragma unroll 2
      for (int i = 0; i < kStepRun; ++i) step(buf, i);
    } else {
#pragma unroll 1
      for (int i = 0; i < n_t % kStepRun; ++i) step(buf, i);
    }
    if (c + 1 < n_c) put(buf ^ 1);
    __syncthreads();
  }
  // the last state out, coalesced (rows[0] was last read before the loop)
  store_row<N>(&sm.rows[0][tid][0], s);
  __syncthreads();
  for (int e = tid; e < n_live * N; e += kThreads)
    s_out[(b * n_d + d0) * N + e] = sm.rows[0][e / N][e % N];
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

// 2**e for -126 <= e <= 127, exactly
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// The `chunk` route's shared memory (above the 48 KB of a static
// allocation in float32: 52.1 KB, four blocks an SM)
template <typename T, int N>
struct ChunkSm {
  T su[2][kChunk][kThreads];  // u of a chunk, two buffers (cp.async)
  T sy[kChunk][kThreads];     // y of a chunk
  float sb[kChunk][N], sc[kChunk][N];
  float sdt[kChunk];
};

// The `chunk` route: prefill, D a multiple of kVecOf<T>.  The next
// chunk's u arrives by cp.async while this one is walked.  Four blocks an
// SM (a block a (batch row, 128 channels): 512 at Jamba prefill, 3.9 an
// SM), so the compiler may give a thread up to 128 registers, and four
// steps an iteration use them.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 4)
mamba_chunk_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ a, const float* __restrict__ s0,
                   T* __restrict__ y, float* __restrict__ s_out,
                   int64_t n_t, int64_t n_d) {
  constexpr int kE = kVecOf<T>;
  static_assert(N % kE == 0, "B and C rows are staged as 16-byte vectors");
  constexpr int kVec = kThreads / kE;  // 16-byte vectors of a step's u or y
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSm<T, N>& sm = *reinterpret_cast<ChunkSm<T, N>*>(smem_raw);
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
  const auto steps = [&](int64_t t0) {
    return static_cast<int>(n_t - t0 < kChunk ? n_t - t0 : kChunk);
  };
  // u of the chunk at step t0 into buffer buf, 16 bytes a thread
  const auto load_u = [&](int64_t t0, int buf) {
    for (int e = tid; e < steps(t0) * kVec; e += kThreads) {
      const int c = e / kVec, v = e % kVec;
      const bool ok = d0 + v * kE < n_d;
      cp_async16(&sm.su[buf][c][v * kE],
                 u + (b * n_t + t0 + c) * n_d + (ok ? d0 + v * kE : 0), ok);
    }
    cp_async_commit();
  };
  // y of the chunk at step t0 (len steps) from sy, 16 bytes a thread
  const auto flush = [&](int64_t t0, int len) {
    for (int e = tid; e < len * kVec; e += kThreads) {
      const int c = e / kVec, v = e % kVec;
      if (d0 + v * kE < n_d)
        *reinterpret_cast<uint4*>(y + (b * n_t + t0 + c) * n_d + d0 + v * kE) =
            *reinterpret_cast<const uint4*>(&sm.sy[c][v * kE]);
    }
  };
  load_u(0, 0);
  int buf = 0;
  for (int64_t t0 = 0; t0 < n_t; t0 += kChunk, buf ^= 1) {
    const int len = steps(t0);
    const bool more = t0 + kChunk < n_t;
    __syncthreads();  // the last chunk's readers are done
    if (t0 > 0) flush(t0 - kChunk, kChunk);
    if (more) load_u(t0 + kChunk, buf ^ 1);
    for (int e = tid; e < 2 * len * (N / kE); e += kThreads) {
      const int which = e / (len * (N / kE)), f = e % (len * (N / kE));
      const int c = f / (N / kE), n = f % (N / kE) * kE;
      float vals[kE];
      load_row<T, kE>(vals, (which ? cm : bm) + (b * n_t + t0 + c) * N + n);
      store_row<kE>(which ? &sm.sc[c][n] : &sm.sb[c][n], vals);
    }
    for (int c = tid; c < len; c += kThreads)
      sm.sdt[c] = to_f(delta[b * n_t + t0 + c]);
    if (more) {
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (!live) continue;
    // Inside the chunk the registers hold 2**(c+1) s after step c: with
    // E = ex2(1 + dt a log2 e) = 2 exp(dt a), 2**(c+1) s_c = E (2**c
    // s_{c-1}) + (2**(c+1) x) B, every power of two exact, so the state is
    // exp_neg's bit for bit without its halving multiply (a sixth of the
    // step's float32 instructions, which share the dispatch slots with the
    // exps); y takes 2**-(c+1) once, the state 2**-len at the chunk's end.
    // Four steps an iteration and the read-out in two chains, so that the
    // next steps' exponentials are dispatched beside this step's sums.
#pragma unroll 4
    for (int c = 0; c < len; ++c) {
      const float dt = sm.sdt[c];
      const float x = dt * to_f(sm.su[buf][c][tid]) * pow2(c + 1);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 2) {
        s[n] = fmaf(ex2(fmaf(dt, a2[n], 1.f)), s[n], x * sm.sb[c][n]);
        s[n + 1] = fmaf(ex2(fmaf(dt, a2[n + 1], 1.f)), s[n + 1],
                        x * sm.sb[c][n + 1]);
        acc0 = fmaf(s[n], sm.sc[c][n], acc0);
        acc1 = fmaf(s[n + 1], sm.sc[c][n + 1], acc1);
      }
      sm.sy[c][tid] = from_f<T>((acc0 + acc1) * pow2(-(c + 1)));
    }
#pragma unroll
    for (int n = 0; n < N; ++n) s[n] *= pow2(-len);
  }
  __syncthreads();
  const int64_t last = (n_t - 1) / kChunk * kChunk;
  flush(last, static_cast<int>(n_t - last));
  if (live) store_row<N>(s_out + (b * n_d + d) * N, s);
}


// The `chunk` backward route: prefill, D a multiple of kVecOf<T>, every
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

// kQ activations (aligned to their size) as float32
__device__ __forceinline__ void ld4(float (&out)[kQ], const float* p) {
  lds4(out, p);
}

__device__ __forceinline__ void ld4(float (&out)[kQ], const bf16* p) {
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
template <typename T, int N>
__global__ void __launch_bounds__(kBndThreads)
mamba_bound_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                   const T* __restrict__ bm, const T* __restrict__ cm,
                   const float* __restrict__ a, const float* __restrict__ s0,
                   const T* __restrict__ dy, const float* __restrict__ ds,
                   float* __restrict__ ws_s, float* __restrict__ ws_g,
                   float* __restrict__ ds0, int64_t n_t, int64_t n_d) {
  static_assert(N == 4 * kQ, "four threads a channel");
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kE = kVecOf<T>;
  constexpr int kCh = kBndThreads / (N / kQ);  // channels a block
  constexpr int kVV = kCh / kE, kVW = N / kE;  // 16-byte vectors a step
  __shared__ float sdt[2][kUnitM];
  __shared__ __align__(16) T sv[2][kUnitM][kCh];
  __shared__ __align__(16) T sw[2][kUnitM][N];
  const int tid = threadIdx.x, q = tid % (N / kQ), dl = tid / (N / kQ);
  const int64_t b = blockIdx.y, d0 = blockIdx.x * int64_t{kCh}, d = d0 + dl;
  const bool live = d < n_d, fwd = blockIdx.z == 0;
  const int64_t n_u = (n_t + kUnitM - 1) / kUnitM;
  const T* vsrc = fwd ? u : dy;
  const T* wsrc = fwd ? bm : cm;
  const int64_t at = (b * n_d + d) * N + q * kQ;  // (b, d, quarter)
  // unit k's u (or dy) and B (or C) into buffer buf; rows past T and
  // channels past D are zeros
  const auto load = [&](int64_t k, int buf) {
    for (int e = tid; e < kUnitM * (kVV + kVW); e += kBndThreads) {
      const bool isv = e < kUnitM * kVV;
      const int f = isv ? e : e - kUnitM * kVV;
      const int c = isv ? f / kVV : f / kVW;
      const int x = (isv ? f % kVV : f % kVW) * kE;
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
          const float x = dt * to_f(sv[buf][c][dl]);
          float w4[kQ];
          ld4(w4, &sw[buf][c][q * kQ]);
#pragma unroll
          for (int j = 0; j < kQ; ++j)
            m[j] = fmaf(exp_neg(dt, a2[j]), m[j], x * w4[j]);
        }
      } else {
#pragma unroll 4
        for (int c = len - 1; c >= 0; --c) {
          const float dt = sdt[buf][c];
          const float v = to_f(sv[buf][c][dl]);
          float w4[kQ];
          ld4(w4, &sw[buf][c][q * kQ]);
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
template <typename T, int N>
struct GradSm {
  float sdt[kUnitM];
  float sb[kUnitM][N], sc[kUnitM][N];  // B and C of the unit
  // u, dy and du of a group
  T su[kUnitM][kGradCh], sdy[kUnitM][kGradCh], sdu[kUnitM][kGradCh];
  float acc[kGradThreads / 32][kUnitM][2 * N + 1];  // a slot a warp
};

template <typename T, int N>
__global__ void __launch_bounds__(kGradThreads)
mamba_grad_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ a, const T* __restrict__ dy,
                  const float* __restrict__ ws_s,
                  const float* __restrict__ ws_g, T* __restrict__ du,
                  float* __restrict__ part, float* __restrict__ da_ws,
                  int64_t n_t, int64_t n_d) {
  static_assert(N == 4 * kQ, "four lanes a channel, eight channels a warp");
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int kE = kVecOf<T>;
  constexpr int kWarpsG = kGradThreads / 32;
  constexpr int kS = 2 * N + 1;  // dB, dC (N each) and ddelta a step
  constexpr int kCh = kGradCh;
  constexpr int kNSub = kUnitM / kSub;
  static_assert(kCh == kGradThreads / (N / kQ), "a group's channels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSm<T, N>& sm = *reinterpret_cast<GradSm<T, N>*>(smem_raw);
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
  for (int e = tid; e < 2 * len * (N / kE); e += kGradThreads) {
    const int which = e / (len * (N / kE)), f = e % (len * (N / kE));
    const int c = f / (N / kE), x = f % (N / kE) * kE;
    float vals[kE];
    load_row<T, kE>(vals, (which ? cm : bm) + (b * n_t + t0 + c) * N + x);
#pragma unroll
    for (int y = 0; y < kE; ++y) (which ? sc : sb)[c][x + y] = vals[y];
  }
  for (int64_t d0 = blockIdx.x * int64_t{kBlkCh};
       d0 < n_d && d0 < (blockIdx.x + 1) * int64_t{kBlkCh}; d0 += kCh) {
    const int64_t d = d0 + dl;
    const bool live = d < n_d;
    __syncthreads();  // the last group's readers are done
    for (int e = tid; e < 2 * len * (kCh / kE); e += kGradThreads) {
      const int which = e / (len * (kCh / kE)), f = e % (len * (kCh / kE));
      const int c = f / (kCh / kE), x = f % (kCh / kE) * kE;
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
      const float dt = sdt[c], x = dt * to_f(su[c][dl]);
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
          const float dt = sdt[c], uv = to_f(su[c][dl]);
          const float dyv = to_f(sdy[c][dl]);
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
          if (q == 0) sdu[c][dl] = from_f<T>(v * dt);
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
    for (int e = tid; e < len * (kCh / kE); e += kGradThreads) {
      const int c = e / (kCh / kE), x = e % (kCh / kE) * kE;
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

// ---------------------------------------------------------------------------
// the step backward pair
// ---------------------------------------------------------------------------
//
// The inputs the chunk route refuses (T = 1, widths off the 16-byte
// vector, unaligned tensors): the chunk backward route's passes and
// shapes (a thread per (channel, quarter of the state), kSub-step
// stretches in registers) in units of kStepUnitM steps, with the step
// forward's arithmetic and roundings (expf, x = delta u rounded to T,
// separate products and sums; dC takes the state rounded to C's dtype, as
// the read-out does), so that every state rebuilt is the loop's bit for
// bit, and with scalar loads through shared memory at any width and
// alignment.  Units of 32 steps, not the chunk route's 64: pass 2 then
// holds half the checkpoints and runs twice the blocks (`python -m
// repro_torch.launch.step_bwd_units` times both).
constexpr int kStepUnitM = 32;  // steps a unit of the step pair

// Pass 1, as mamba_bound_kernel (capped at two blocks an SM: uncapped,
// ptxas takes over 170 registers and leaves one): blockIdx.z = 0 walks
// the state forward from s0 and writes the state entering every unit into
// ws_s;
// blockIdx.z = 1 walks the cotangent back, h <- exp(delta_t a) (h + dy_t
// C_t), writes the cotangent leaving every unit into ws_g and the first
// state's gradient into ds0.  A unit's u (or dy), B (or C) and delta are
// staged as float32, two buffers, the next unit loading into registers
// while this one is walked.
template <typename T, int N>
__global__ void __launch_bounds__(kBndThreads, 2)
mamba_step_bound_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                        const T* __restrict__ bm, const T* __restrict__ cm,
                        const float* __restrict__ a,
                        const float* __restrict__ s0,
                        const T* __restrict__ dy,
                        const float* __restrict__ ds,
                        float* __restrict__ ws_s, float* __restrict__ ws_g,
                        float* __restrict__ ds0, int64_t n_t, int64_t n_d) {
  static_assert(N == 4 * kQ, "four threads a channel");
  constexpr int kCh = kBndThreads / (N / kQ);        // channels a block
  constexpr int kLv = kStepUnitM * kCh / kBndThreads;  // u (dy) a thread
  constexpr int kLw = kStepUnitM * N / kBndThreads;    // B (C) a thread
  static_assert(kStepUnitM <= kBndThreads, "a thread a step of delta");
  __shared__ float sdt[2][kStepUnitM];
  __shared__ __align__(16) float sv[2][kStepUnitM][kCh];
  __shared__ __align__(16) float sw[2][kStepUnitM][N];
  const int tid = threadIdx.x, q = tid % (N / kQ), dl = tid / (N / kQ);
  const int64_t b = blockIdx.y, d0 = blockIdx.x * int64_t{kCh}, d = d0 + dl;
  const bool live = d < n_d, fwd = blockIdx.z == 0;
  const int64_t n_u = (n_t + kStepUnitM - 1) / kStepUnitM;
  const T* vsrc = fwd ? u : dy;
  const T* wsrc = fwd ? bm : cm;
  const int64_t at = (b * n_d + d) * N + q * kQ;  // (b, d, quarter)
  float pv[kLv], pw[kLw], pdt;  // the next unit; past T and D zeros
  const auto fetch = [&](int64_t k) {
#pragma unroll
    for (int i = 0; i < kLv; ++i) {
      const int e = tid + i * kBndThreads, c = e / kCh, x = e % kCh;
      const int64_t t = k * kStepUnitM + c;
      pv[i] = t < n_t && d0 + x < n_d
                  ? to_f(vsrc[(b * n_t + t) * n_d + d0 + x]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLw; ++i) {
      const int e = tid + i * kBndThreads, c = e / N;
      const int64_t t = k * kStepUnitM + c;
      pw[i] = t < n_t ? to_f(wsrc[(b * n_t + t) * N + e % N]) : 0.f;
    }
    const int64_t t = k * kStepUnitM + tid;
    pdt = tid < kStepUnitM && t < n_t ? to_f(delta[b * n_t + t]) : 0.f;
  };
  const auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLv; ++i)
      (&sv[buf][0][0])[tid + i * kBndThreads] = pv[i];
#pragma unroll
    for (int i = 0; i < kLw; ++i)
      (&sw[buf][0][0])[tid + i * kBndThreads] = pw[i];
    if (tid < kStepUnitM) sdt[buf][tid] = pdt;
  };
  float an[kQ], m[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    an[j] = live ? a[d * N + q * kQ + j] : 0.f;
    m[j] = !live ? 0.f : fwd ? s0[at + j] : ds ? ds[at + j] : 0.f;
  }
  fetch(fwd ? 0 : n_u - 1);
  put(0);
  __syncthreads();
  for (int64_t it = 0; it < n_u; ++it) {
    const int64_t k = fwd ? it : n_u - 1 - it;
    const int buf = it & 1;
    const int len = static_cast<int>(
        n_t - k * kStepUnitM < kStepUnitM ? n_t - k * kStepUnitM : kStepUnitM);
    if (it + 1 < n_u) fetch(fwd ? k + 1 : k - 1);
    if (live) {
      float* out = (fwd ? ws_s : ws_g) + ((b * n_u + k) * n_d + d) * N +
                   q * kQ;
#pragma unroll
      for (int j = 0; j < kQ; ++j) out[j] = m[j];
      if (fwd) {
        for (int c = 0; c < len; ++c) {
          const float dt = sdt[buf][c];
          const float x = rnd<T>(__fmul_rn(dt, sv[buf][c][dl]));
          float w4[kQ];
          lds4(w4, &sw[buf][c][q * kQ]);
#pragma unroll
          for (int j = 0; j < kQ; ++j)
            m[j] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, an[j])), m[j]),
                             __fmul_rn(x, w4[j]));
        }
      } else {
        for (int c = len - 1; c >= 0; --c) {
          const float dt = sdt[buf][c], v = sv[buf][c][dl];
          float w4[kQ];
          lds4(w4, &sw[buf][c][q * kQ]);
#pragma unroll
          for (int j = 0; j < kQ; ++j)
            m[j] = expf(__fmul_rn(dt, an[j])) * fmaf(v, w4[j], m[j]);
        }
      }
    }
    if (it + 1 < n_u) put(buf ^ 1);
    __syncthreads();
  }
  if (!fwd && live) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) ds0[at + j] = m[j];
  }
}

// pass 2's shared memory (33.4 KB)
template <int N>
struct StepGradSm {
  float sdt[kStepUnitM];
  float sb[kStepUnitM][N], sc[kStepUnitM][N];  // B and C of the unit
  // u, dy and du of a group
  float su[kStepUnitM][kGradCh], sdy[kStepUnitM][kGradCh];
  float sdu[kStepUnitM][kGradCh];
  float acc[kGradThreads / 32][kStepUnitM][2 * N + 1];  // a slot a warp
};

// Pass 2, as mamba_grad_kernel (a block per (channel block of kBlkCh,
// unit, batch), a thread per (channel of a group of 32, quarter of the
// state), stretches of kSub steps recomputed from checkpoints, the sums
// over channels through one reduce-scatter a step into a warp's slot of
// shared memory, partial sums out for colsum_kernel), with the step
// forward's arithmetic.  expf costs about eight instructions, so a
// stretch keeps its exponentials and states in registers for the walk
// back: two expf a state value a step here, not three (`python -m
// repro_torch.launch.step_bwd_units` times it against recomputing them).
// The cap of four blocks an SM holds ptxas to 128 registers (a few
// spilled); at three it takes 168, uncapped 231 and leaves two (the
// script times three against four).
template <typename T, int N>
__global__ void __launch_bounds__(kGradThreads, 4)
mamba_step_grad_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                       const T* __restrict__ bm, const T* __restrict__ cm,
                       const float* __restrict__ a, const T* __restrict__ dy,
                       const float* __restrict__ ws_s,
                       const float* __restrict__ ws_g, T* __restrict__ du,
                       float* __restrict__ part, float* __restrict__ da_ws,
                       int64_t n_t, int64_t n_d) {
  static_assert(N == 4 * kQ, "four lanes a channel, eight channels a warp");
  constexpr int kWarpsG = kGradThreads / 32;
  constexpr int kS = 2 * N + 1;  // dB, dC (N each) and ddelta a step
  constexpr int kCh = kGradCh;
  constexpr int kNSub = kStepUnitM / kSub;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StepGradSm<N>& sm = *reinterpret_cast<StepGradSm<N>*>(smem_raw);
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
  const int64_t n_u = (n_t + kStepUnitM - 1) / kStepUnitM;
  const int64_t t0 = unit * kStepUnitM;
  const int len =
      static_cast<int>(n_t - t0 < kStepUnitM ? n_t - t0 : kStepUnitM);
  for (int e = tid; e < kWarpsG * kStepUnitM * kS; e += kGradThreads)
    (&acc[0][0][0])[e] = 0.f;
  for (int c = tid; c < kStepUnitM; c += kGradThreads)
    sdt[c] = c < len ? to_f(delta[b * n_t + t0 + c]) : 0.f;
  for (int e = tid; e < 2 * kStepUnitM * N; e += kGradThreads) {
    const int which = e / (kStepUnitM * N), c = e / N % kStepUnitM;
    const int n = e % N;
    (which ? sc : sb)[c][n] =
        c < len ? to_f((which ? cm : bm)[(b * n_t + t0 + c) * N + n]) : 0.f;
  }
  for (int64_t d0 = blockIdx.x * int64_t{kBlkCh};
       d0 < n_d && d0 < (blockIdx.x + 1) * int64_t{kBlkCh}; d0 += kCh) {
    const int64_t d = d0 + dl;
    const bool live = d < n_d;
    __syncthreads();  // the last group's readers are done
    for (int e = tid; e < 2 * kStepUnitM * kCh; e += kGradThreads) {
      const int which = e / (kStepUnitM * kCh), c = e / kCh % kStepUnitM;
      const int x = e % kCh;
      (which ? sdy : su)[c][x] =
          c < len && d0 + x < n_d
              ? to_f((which ? dy : u)[(b * n_t + t0 + c) * n_d + d0 + x])
              : 0.f;
    }
    __syncthreads();
    const int64_t at = ((b * n_u + unit) * n_d + d) * N + q * kQ;
    float an[kQ], s[kQ], h[kQ], da[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      an[j] = live ? a[d * N + q * kQ + j] : 0.f;
      s[j] = live ? ws_s[at + j] : 0.f;
      h[j] = live ? ws_g[at + j] : 0.f;
      da[j] = 0.f;
    }
    // one step forward, the step forward's roundings: s_{t-1} -> s_t,
    // and its exp(delta_t a) into e
    const auto step = [&](float (&v)[kQ], float (&e)[kQ], int c) {
      const float dt = sdt[c];
      const float x = rnd<T>(__fmul_rn(dt, su[c][dl]));
      float bv[kQ];
      lds4(bv, &sb[c][q * kQ]);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        e[j] = expf(__fmul_rn(dt, an[j]));
        v[j] = __fadd_rn(__fmul_rn(e[j], v[j]), __fmul_rn(x, bv[j]));
      }
    };
    const auto walk = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      float ck[kNSub][kQ];  // the state entering every kSub steps
#pragma unroll
      for (int k = 0; k < kNSub; ++k) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) ck[k][j] = s[j];
#pragma unroll
        for (int c = k * kSub; c < (k + 1) * kSub; ++c) {
          float e[kQ];
          if (kWhole || c < len) step(s, e, c);
        }
      }
#pragma unroll
      for (int k = kNSub - 1; k >= 0; --k) {
        if (!kWhole && k * kSub >= len) continue;
        // the stretch's states: sp[c] = s_{t-1} and sp[c + 1] = s_t of its
        // step c, and ep[c] its exp(delta_t a), so that the walk back
        // recomputes neither
        float sp[kSub + 1][kQ], ep[kSub][kQ];
#pragma unroll
        for (int c = 0; c <= kSub; ++c) {
#pragma unroll
          for (int j = 0; j < kQ; ++j) sp[c][j] = c ? sp[c - 1][j] : ck[k][j];
          if (c && (kWhole || k * kSub + c - 1 < len))
            step(sp[c], ep[c - 1], k * kSub + c - 1);
        }
#pragma unroll
        for (int c8 = kSub - 1; c8 >= 0; --c8) {
          const int c = k * kSub + c8;
          if (!kWhole && c >= len) continue;
          const float dt = sdt[c], uv = su[c][dl], dyv = sdy[c][dl];
          const float x = rnd<T>(__fmul_rn(dt, uv));
          float bv[kQ], cv[kQ], p[2 * kQ];
          lds4(bv, &sb[c][q * kQ]);
          lds4(cv, &sc[c][q * kQ]);
          float dx = 0.f, ga = 0.f;
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const float e = ep[c8][j];
            h[j] = fmaf(dyv, cv[j], h[j]);            // dL/ds_t
            p[kQ + j] = dyv * rnd<T>(sp[c8 + 1][j]);  // dC
            p[j] = h[j] * x;                          // dB
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
          if (q == 0) sdu[c][dl] = v * dt;
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
    if (len == kStepUnitM) {
      walk(std::true_type{});
    } else {
      walk(std::false_type{});
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) da_ws[at + j] = da[j];
    }
    __syncthreads();  // sdu written
    for (int e = tid; e < len * kCh; e += kGradThreads) {
      const int c = e / kCh, x = e % kCh;
      if (d0 + x < n_d)
        du[(b * n_t + t0 + c) * n_d + d0 + x] = from_f<T>(sdu[c][x]);
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
  mamba_fwd_kernel<T, 16>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const T*>(delta),
          static_cast<const T*>(bm), static_cast<const T*>(cm),
          static_cast<const float*>(a), static_cast<const float*>(s0),
          static_cast<T*>(y), static_cast<float*>(s_out), n_t, n_d);
  return cudaGetLastError();
}

// The pair's passes, and the sums of their partials in a fixed order.
// BoundK, GradK: the passes' kernels, in units of kUnit steps; the chunk
// route's (16-byte vectors, D a multiple of kVecOf<T>) or the step pair's
// (any width and alignment)
template <typename T, int kUnit, typename BoundK, typename GradK>
int bwd_passes(BoundK bound, GradK grad, int smem, const void* u,
               const void* delta, const void* bm, const void* cm,
               const void* a, const void* s0, const void* dy, const void* ds,
               void* ws, void* du, void* sums, void* da, void* ds0,
               int64_t n_b, int64_t n_t, int64_t n_d, int64_t n_s,
               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto up = static_cast<const T*>(u);
  const auto dp = static_cast<const T*>(delta);
  const auto bp = static_cast<const T*>(bm);
  const auto cp = static_cast<const T*>(cm);
  const auto ap = static_cast<const float*>(a);
  const auto dyp = static_cast<const T*>(dy);
  const int64_t n_u = (n_t + kUnit - 1) / kUnit;
  const int64_t n_blk = (n_d + kBlkCh - 1) / kBlkCh;
  const int64_t m = n_b * n_u * n_d * n_s;
  float* ws_s = static_cast<float*>(ws);
  float* ws_g = ws_s + m;
  float* da_ws = ws_g + m;
  float* part = da_ws + m;
  constexpr int kCh = kBndThreads / (16 / kQ);
  bound<<<dim3((n_d + kCh - 1) / kCh, n_b, 2), kBndThreads, 0, st>>>(
      up, dp, bp, cp, ap, static_cast<const float*>(s0), dyp,
      static_cast<const float*>(ds), ws_s, ws_g, static_cast<float*>(ds0),
      n_t, n_d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(grad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  grad<<<dim3(n_blk, n_u, n_b), kGradThreads, smem, st>>>(
      up, dp, bp, cp, ap, dyp, ws_s, ws_g, static_cast<T*>(du), part, da_ws,
      n_t, n_d);
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

template <typename T>
int bwd(const void* u, const void* delta, const void* bm, const void* cm,
        const void* a, const void* s0, const void* dy, const void* ds,
        void* ws, void* du, void* sums, void* da, void* ds0, int64_t n_b,
        int64_t n_t, int64_t n_d, int64_t n_s, void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_t < 1 || n_s != 16) return cudaErrorInvalidValue;
  return bwd_passes<T, kStepUnitM>(
      mamba_step_bound_kernel<T, 16>, mamba_step_grad_kernel<T, 16>,
      static_cast<int>(sizeof(StepGradSm<16>)), u, delta, bm, cm, a, s0, dy,
      ds, ws, du, sums, da, ds0, n_b, n_t, n_d, n_s, stream);
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


template <typename T>
int chunk_fwd(const void* u, const void* delta, const void* bm,
              const void* cm, const void* a, const void* s0, void* y,
              void* s_out, int64_t n_b, int64_t n_t, int64_t n_d,
              int64_t n_s, void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_t < 1 || n_s != 16 || n_d % kVecOf<T>) return cudaErrorInvalidValue;
  const dim3 grid((n_d + kThreads - 1) / kThreads, n_b);
  const int smem = static_cast<int>(sizeof(ChunkSm<T, 16>));
  const cudaError_t err = cudaFuncSetAttribute(
      mamba_chunk_kernel<T, 16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  mamba_chunk_kernel<T, 16>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u), static_cast<const T*>(delta),
          static_cast<const T*>(bm), static_cast<const T*>(cm),
          static_cast<const float*>(a), static_cast<const float*>(s0),
          static_cast<T*>(y), static_cast<float*>(s_out), n_t, n_d);
  return cudaGetLastError();
}

template <typename T>
int chunk_bwd(const void* u, const void* delta, const void* bm, const void* cm,
              const void* a, const void* s0, const void* dy, const void* ds,
              void* ws, void* du, void* sums, void* da, void* ds0,
              int64_t n_b, int64_t n_t, int64_t n_d, int64_t n_s,
              void* stream) {
  if (n_b * n_d == 0) return 0;
  if (n_t < 1 || n_s != 16 || n_d % kVecOf<T>) return cudaErrorInvalidValue;
  return bwd_passes<T, kUnitM>(
      mamba_bound_kernel<T, 16>, mamba_grad_kernel<T, 16>,
      static_cast<int>(sizeof(GradSm<T, 16>)), u, delta, bm, cm, a, s0, dy,
      ds, ws, du, sums, da, ds0, n_b, n_t, n_d, n_s, stream);
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

// the step pair: u, delta, B, C, a (float32), s0 (float32), dy, ds (float32
// or null), ws (float32: 3 * batch * ceil(T / 32) * D * N + ceil(D / 256) *
// batch * T * (2N + 1)); du, sums
// (float32 (batch, T, 2N + 1): dB, dC, ddelta), da (float32 (D, N)), ds0
// (float32); batch, T, D, N; stream.  Any width and alignment, T >= 1.
#define MAMBA_BWD(name, T)                                                    \
  extern "C" int name(const void* u, const void* delta, const void* bm,       \
                      const void* cm, const void* a, const void* s0,          \
                      const void* dy, const void* ds, void* ws, void* du,     \
                      void* sums, void* da, void* ds0, int64_t n_b,           \
                      int64_t n_t, int64_t n_d, int64_t n_s, void* stream) {  \
    return bwd<T>(u, delta, bm, cm, a, s0, dy, ds, ws, du, sums, da, ds0,     \
                  n_b, n_t, n_d, n_s, stream);                                \
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

// the chunk route: u, delta, B, C, a (float32), s0 (float32), y, s_out
// (float32); batch, T, D (a multiple of 8 in bf16, of 4 in float32), N;
// stream.  Every tensor 16-byte aligned.
#define MAMBA_CHUNK(name, T)                                                  \
  extern "C" int name(const void* u, const void* delta, const void* bm,       \
                      const void* cm, const void* a, const void* s0, void* y, \
                      void* s_out, int64_t n_b, int64_t n_t, int64_t n_d,     \
                      int64_t n_s, void* stream) {                            \
    return chunk_fwd<T>(u, delta, bm, cm, a, s0, y, s_out, n_b, n_t, n_d,     \
                        n_s, stream);                                         \
  }
MAMBA_CHUNK(mamba_scan_chunk_f32, float)
MAMBA_CHUNK(mamba_scan_chunk_bf16, bf16)

// the chunk backward route: u, delta, B, C, a (float32), s0 (float32), dy,
// ds (float32 or null), ws (float32: 3 * batch * ceil(T / 64) * D * N +
// ceil(D / 256) * batch * T * (2N + 1)); du, sums (float32 (batch, T,
// 2N + 1): dB, dC, ddelta), da (float32 (D, N)), ds0 (float32); batch, T,
// D (a multiple of 8 in bf16, of 4 in float32), N; stream.  Every tensor
// 16-byte aligned.
#define MAMBA_BWD_CHUNK(name, T)                                              \
  extern "C" int name(const void* u, const void* delta, const void* bm,       \
                      const void* cm, const void* a, const void* s0,          \
                      const void* dy, const void* ds, void* ws, void* du,     \
                      void* sums, void* da, void* ds0, int64_t n_b,           \
                      int64_t n_t, int64_t n_d, int64_t n_s, void* stream) {  \
    return chunk_bwd<T>(u, delta, bm, cm, a, s0, dy, ds, ws, du, sums, da,    \
                        ds0, n_b, n_t, n_d, n_s, stream);                     \
  }
MAMBA_BWD_CHUNK(mamba_scan_bwd_chunk_f32, float)
MAMBA_BWD_CHUNK(mamba_scan_bwd_chunk_bf16, bf16)
