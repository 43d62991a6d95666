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
// Forward (the `step` route: T = 1, and tensors off the 16-byte boundary
// that the chunked route refuses), two kernels behind one entry.  At T = 1
// (decode), `rwkv6_fwd_kernel`: one block per (batch, head), hd threads;
// thread j owns column j of the state, hd float32 registers, and y_t[j]
// is its own sum over rows.  At T >= 2, `rwkv6_step_fwd_kernel`: 2 hd
// threads a (batch, head), a tile of hd / 8 rows and four columns a
// thread, tokens staged eight at a time with the next eight loading into
// registers, one barrier a run, y's sums over rows meeting in a fixed
// tree of shuffles (below).  Every rounding is the plain version's:
// __fmul_rn / __fadd_rn keep nvcc from contracting k·v, S + u·kv and the
// state update into FMAs that the plain version's separate elementwise
// ops do not make, so the state is bitwise the plain version's on the
// card; y differs by the read-out's order of summation
// (`ref.rwkv6_scan_step` sums in the T >= 2 kernel's order).
//
// Backward (the `step` pair, for what the chunked routes refuse: T = 1,
// tensors off the 16-byte boundary), parallel in T, with no workspace of
// every step's state.  Both walks of it need nothing from the other: the
// state S_t = diag(w_t) S_{t-1} + kv_t needs no cotangent, and the
// cotangent G_{t-1} = diag(w_t) G_t + r_t^T dy_t needs no state, and every
// element (i, j) of either evolves alone.  So:
//
// 1. `rwkv6_step_bound_kernel`, 2 * B * H blocks of 256 threads side by
//    side (a TR x TC tile of the hd x hd matrix a thread, hd / 16
//    square): blockIdx.y = 0 walks the states forward from s0 with the
//    forward's roundings and keeps the state entering every unit of
//    kStepUnit = 32 tokens; blockIdx.y = 1 walks the cotangents back from
//    the last state's (or 0), keeps the one leaving every unit and writes
//    the first state's gradient.  The tokens' r, k, v, w, dy arrive 16 at
//    a time through shared memory, the next ones loading into registers
//    while these are walked.  Kept: 2 * B * H * ceil(T / 32) * hd^2 * 4
//    bytes, 0.268 GB at RWKV-6-7B's width, B = 2, T = 2048, where every
//    step's state would be 4.295 GB.
// 2. `rwkv6_step_grad_kernel`, a block per (unit, batch x head): the
//    unit's tokens staged in shared memory as float32, then its rows in
//    groups of 32 (a pair of rows and hd / 16 columns a thread, 16 lanes
//    a pair of rows), and for each group its stretches of kSub = 8 tokens
//    from the last: the state entering the stretch rebuilt from the
//    unit's (the forward's roundings, so bitwise the loop's state), the
//    stretch's states kept in registers, then walked back with the
//    cotangent G (column j of row i in the thread that holds S[i][j]):
//
//      dM[i,j]  = r_i dy_j                    dr_i = sum_j M[i,j] dy_j
//      dkv      = G + u_i dM                  dw_i = sum_j G[i,j] S_{t-1}[i,j]
//      dk_i     = sum_j dkv[i,j] v_j          dv_j = sum_i dkv[i,j] k_i
//      du_i    += sum_j dM[i,j] kv[i,j]       G    = diag(w_t) G + dM
//
//    (M = S_{t-1} + u kv rounded to r's dtype, kv rounded as the forward
//    rounds it).  The four sums over j (8 values a thread) meet in a
//    reduce-scatter over the row pair's 16 lanes (7 shuffles and one
//    more); dv's over i in one shuffle across the warp's row pairs, then
//    over the warps through shared memory in a fixed order, and over the
//    groups in order.  dr, dw, dk and dv leave through shared memory in
//    rows; du sums over the unit in the lanes of its rows and leaves as
//    a partial a (batch, unit).
// 3. `colsum_kernel` (scan.cuh) sums du's partials in a fixed order.
// Nothing is added atomically, so two runs give the same gradients bit
// for bit.  Gradients are float32 throughout and round once to the
// inputs' dtypes; the roundings of the forward count as the identity
// (autograd's cast gradient).
//
// Bound: 20 hd^2 operations a (batch, token, head) backward (the reverse
// step's 14 and the recomputed S and M's 6), float32 on the CUDA cores
// (67 TFLOP/s); at RWKV-6-7B training (B = 2, T = 2048, H = 64, hd = 64)
// 21.5 GFLOP, 321 us.  These kernels do about twice that: the boundary
// passes walk both matrices once more, and a stretch rebuilds its states
// from the unit's start (2.4 state steps a token).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "scan.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const T* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ y, float* __restrict__ s_out, int64_t n_t,
                 int64_t n_h) {
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
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = rnd<T>(__fmul_rn(sk[cur][i], vj));
      const float m = rnd<T>(__fadd_rn(s[i], __fmul_rn(su[i], kv)));
      acc[i % 4] = fmaf(sr[cur][i], m, acc[i % 4]);
      s[i] = __fadd_rn(__fmul_rn(sw[cur][i], s[i]), kv);
    }
    y[at(t)] = from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    if (t + 1 < n_t) {
      sr[cur ^ 1][j] = rn;
      sk[cur ^ 1][j] = kn;
      sw[cur ^ 1][j] = wn;
      vj = vn;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[(bh * HD + i) * HD + j] = s[i];
}

// ---------------------------------------------------------------------------
// the step forward at T >= 2
// ---------------------------------------------------------------------------

constexpr int kRun = 8;  // tokens staged at a time by the T >= 2 forward

// The T >= 2 forward's shape: 8 row lanes and hd / 4 column groups of four
// threads a (batch, head); a thread holds rows TR of four columns.  Lane
// bits 0-1 pick the column group within the warp, bits 2-4 the row lane,
// so a quarter-warp reads two row addresses and the column sums run over
// lane bits 2-4.
template <int HD>
struct StepFwd {
  static constexpr int kThreads = 2 * HD;
  static constexpr int TR = HD / 8, TC = 4;
  // staged rows: at hd 64, rows 32-63 sit four floats further on, so that
  // a warp's eight row lanes read eight 16-byte runs in distinct banks
  static constexpr int kPad = HD > 32 ? HD + 4 : HD;
};

template <int HD>
__device__ __forceinline__ int row_at(int i) {
  return HD > 32 ? i + (i >> 5) * 4 : i;
}

// n consecutive floats of shared memory into registers, as 16-byte (or
// 8-byte) loads: p is 4 * n bytes aligned
template <int NV>
__device__ __forceinline__ void lds_vec(float (&out)[NV], const float* p) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NV; q += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + q);
      out[q] = f.x;
      out[q + 1] = f.y;
      out[q + 2] = f.z;
      out[q + 3] = f.w;
    }
  } else {
    static_assert(NV == 2, "two or a multiple of four");
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x;
    out[1] = f.y;
  }
}

template <typename T, int HD>
struct StepFwdSm {
  float in[2][4][kRun][StepFwd<HD>::kPad];  // r, k, v, w of a run, two buffers
  T y[2][kRun][HD];                         // y of a run, two buffers
  float u[StepFwd<HD>::kPad];
};

// The step forward at T >= 2, a block per (batch, head): the state a TR x 4
// tile a thread, kRun tokens of r, k, v, w staged at a time (two buffers,
// the next run loading into registers by scalar loads while this one is
// walked), one barrier a run.  The state update and the read-out's operand
// M = S + u kv round as rwkv6_fwd_kernel's do, so the state is bitwise the
// loop's.  y_t[j] = sum_i r_i M[i][j]: each thread sums its TR rows in
// order in one fused multiply-add chain a column, then the eight row lanes'
// partial sums meet in a fixed tree, ((P0 + P4) + (P2 + P6)) + ((P1 + P5) +
// (P3 + P7)) with Pl the sum over rows l TR .. l TR + TR - 1: a
// reduce-scatter over lane bits 4 and 3, then one shuffle over bit 2
// (ref.rwkv6_scan_step sums in this order).  y leaves through shared
// memory, a run at a time, in rows.
template <typename T, int HD>
__global__ void __launch_bounds__(StepFwd<HD>::kThreads, 4)
rwkv6_step_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const T* __restrict__ u, const float* __restrict__ s0,
                      T* __restrict__ y, float* __restrict__ s_out,
                      int64_t n_t, int64_t n_h) {
  using F = StepFwd<HD>;
  constexpr int TR = F::TR, TC = F::TC, kThr = F::kThreads;
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ __align__(16) StepFwdSm<T, HD> sm;
  const int tid = threadIdx.x, lane = tid & 31;
  const int i0 = (lane >> 2) * TR;                    // the thread's rows
  const int j0 = ((tid >> 5) * 4 + (lane & 3)) * TC;  // and columns
  const int64_t bh = blockIdx.x, b = bh / n_h, h = bh % n_h;
  const int64_t stride = n_h * HD, base = (b * n_t * n_h + h) * HD;
  const int64_t n_c = (n_t + kRun - 1) / kRun;
  // a thread stages column col of tokens row0, row0 + 2, .. of a run
  constexpr int kPass = kThr / HD;       // tokens a pass of the block (2)
  constexpr int kRows = kRun / kPass;    // passes a run
  const int col = tid % HD, row0 = tid / HD;
  const T* src[4] = {r + base + col, k + base + col, v + base + col,
                     w + base + col};
  const int64_t off0 = row0 * stride, step2 = kPass * stride;
  float pre[4][kRows];  // the next run
  const auto fetch = [&](int64_t c) {
    const int64_t off = c * kRun * stride + off0;
    const bool whole = (c + 1) * kRun <= n_t;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        pre[a][q] = whole || c * kRun + row0 + kPass * q < n_t
                        ? to_f(src[a][off + q * step2]) : 0.f;
  };
  const auto put = [&](int buf) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        sm.in[buf][a][row0 + kPass * q][row_at<HD>(col)] = pre[a][q];
  };
  // y of the run at c from buffer buf, in rows
  T* const yc = y + base + col;
  const auto flush = [&](int64_t c, int buf) {
    const int64_t off = c * kRun * stride + off0;
    const bool whole = (c + 1) * kRun <= n_t;
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (whole || c * kRun + row0 + kPass * q < n_t)
        yc[off + q * step2] = sm.y[buf][row0 + kPass * q][col];
  };
  fetch(0);
  for (int i = tid; i < HD; i += kThr) sm.u[row_at<HD>(i)] = to_f(u[h * HD + i]);
  float s[TR][TC];
#pragma unroll
  for (int x = 0; x < TR; ++x)
#pragma unroll
    for (int c = 0; c < TC; ++c)
      s[x][c] = s0[(bh * HD + i0 + x) * HD + j0 + c];
  put(0);
  __syncthreads();
  float uu[TR];
  lds_vec<TR>(uu, &sm.u[row_at<HD>(i0)]);
  const bool hi4 = lane & 16, hi3 = lane & 8;
  // the column this lane ends with, and whether it writes it
  const int jy = j0 + 2 * hi4 + hi3;
  const bool writer = !(lane & 4);
  const auto token = [&](int buf, int t) {
    float rr[TR], kk[TR], ww[TR], vv[TC];
    lds_vec<TR>(rr, &sm.in[buf][0][t][row_at<HD>(i0)]);
    lds_vec<TR>(kk, &sm.in[buf][1][t][row_at<HD>(i0)]);
    lds_vec<TC>(vv, &sm.in[buf][2][t][row_at<HD>(j0)]);
    lds_vec<TR>(ww, &sm.in[buf][3][t][row_at<HD>(i0)]);
    float acc[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int x = 0; x < TR; ++x)
#pragma unroll
      for (int c = 0; c < TC; c += 2) {
        // rwkv6_fwd_kernel's roundings: kv and M to T, the rest float32
        float kv0 = __fmul_rn(kk[x], vv[c]), kv1 = __fmul_rn(kk[x], vv[c + 1]);
        rnd2<T>(kv0, kv1);
        float m0 = __fadd_rn(s[x][c], __fmul_rn(uu[x], kv0));
        float m1 = __fadd_rn(s[x][c + 1], __fmul_rn(uu[x], kv1));
        rnd2<T>(m0, m1);
        acc[c] = fmaf(rr[x], m0, acc[c]);
        acc[c + 1] = fmaf(rr[x], m1, acc[c + 1]);
        s[x][c] = __fadd_rn(__fmul_rn(ww[x], s[x][c]), kv0);
        s[x][c + 1] = __fadd_rn(__fmul_rn(ww[x], s[x][c + 1]), kv1);
      }
    // the sums over the eight row lanes: columns {0, 1} and {2, 3} trade
    // over lane bit 4, then the pair over bit 3, then bit 2 adds
    const float p0 = sel(hi4, acc[2], acc[0]) +
                     __shfl_xor_sync(kFull, sel(hi4, acc[0], acc[2]), 16);
    const float p1 = sel(hi4, acc[3], acc[1]) +
                     __shfl_xor_sync(kFull, sel(hi4, acc[1], acc[3]), 16);
    float q = sel(hi3, p1, p0) + __shfl_xor_sync(kFull, sel(hi3, p0, p1), 8);
    q += __shfl_xor_sync(kFull, q, 4);
    if (writer) sm.y[buf][t][jy] = from_f<T>(q);
  };
  for (int64_t c = 0; c < n_c; ++c) {
    const int buf = static_cast<int>(c & 1);
    if (c + 1 < n_c) fetch(c + 1);
    if (c > 0) flush(c - 1, buf ^ 1);
    if (c + 1 < n_c || n_t % kRun == 0) {
#pragma unroll 2
      for (int t = 0; t < kRun; ++t) token(buf, t);
    } else {
#pragma unroll 1
      for (int t = 0; t < n_t % kRun; ++t) token(buf, t);
    }
    if (c + 1 < n_c) put(buf ^ 1);
    __syncthreads();
  }
  flush(n_c - 1, static_cast<int>((n_c - 1) & 1));
#pragma unroll
  for (int x = 0; x < TR; ++x)
#pragma unroll
    for (int c = 0; c < TC; ++c)
      s_out[(bh * HD + i0 + x) * HD + j0 + c] = s[x][c];
}

// ---------------------------------------------------------------------------
// the step backward pair
// ---------------------------------------------------------------------------

constexpr int kStepUnit = 32;  // tokens a unit: its boundaries are kept
constexpr int kSub = 8;        // tokens a stretch of pass 2 (in registers)
constexpr int kBndT = 16;      // tokens pass 1 stages at a time
constexpr int kBndThreads = 256;
static_assert(kStepUnit % kBndT == 0 && kStepUnit % kSub == 0,
              "units hold whole staged runs and stretches");

// the activations' element (token t, column col) of one (batch, head)
template <typename T>
__device__ __forceinline__ float act(const T* __restrict__ p, int64_t base,
                                     int64_t stride, int64_t t, int col) {
  return to_f(p[base + t * stride + col]);
}

// Pass 1: blockIdx.y = 0 walks the states forward from s0 and writes the
// state entering every unit into ws_s; blockIdx.y = 1 walks the
// cotangents back from ds (or 0), writes the cotangent leaving every unit
// into ws_g and the first state's gradient into ds0.  A TR x TC tile a
// thread; kBndT tokens of the two vectors and w staged at a time, two
// buffers, the next run loading into registers while this one is walked.
template <typename T, int HD>
__global__ void __launch_bounds__(kBndThreads)
rwkv6_step_bound_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ w,
                        const T* __restrict__ dy,
                        const float* __restrict__ s0,
                        const float* __restrict__ ds,
                        float* __restrict__ ws_s, float* __restrict__ ws_g,
                        float* __restrict__ ds0, int64_t n_t, int64_t n_h) {
  constexpr int TR = HD / 16, TC = HD / 16;  // 16 x 16 threads of tiles
  constexpr int kLoads = 3 * kBndT * HD / kBndThreads;
  __shared__ float sm[2][3][kBndT][HD];  // k, v, w or r, dy, w
  const int tid = threadIdx.x;
  const int i0 = (tid >> 4) * TR, j0 = (tid & 15) * TC;
  const bool fwd = blockIdx.y == 0;
  const int64_t bh = blockIdx.x, b = bh / n_h, h = bh % n_h;
  const int64_t stride = n_h * HD, base = (b * n_t * n_h + h) * HD;
  const int64_t n_c = (n_t + kBndT - 1) / kBndT;
  const int64_t n_u = (n_t + kStepUnit - 1) / kStepUnit;
  const T* a_src = fwd ? k : r;
  const T* b_src = fwd ? v : dy;
  float pre[kLoads];  // the next run, element tid + q * kBndThreads
  const auto fetch = [&](int64_t c) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kBndThreads;
      const int arr = e / (kBndT * HD), row = e / HD % kBndT, col = e % HD;
      const int64_t t = c * kBndT + row;
      const T* src = arr == 0 ? a_src : arr == 1 ? b_src : w;
      pre[q] = t < n_t ? act(src, base, stride, t, col) : 0.f;
    }
  };
  const auto put = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      (&sm[buf][0][0][0])[tid + q * kBndThreads] = pre[q];
  };
  float m[TR][TC];
  const float* init = fwd ? s0 : ds;
#pragma unroll
  for (int x = 0; x < TR; ++x)
#pragma unroll
    for (int y = 0; y < TC; ++y)
      m[x][y] = init ? init[(bh * HD + i0 + x) * HD + j0 + y] : 0.f;
  const auto keep = [&](float* dst) {
#pragma unroll
    for (int x = 0; x < TR; ++x)
#pragma unroll
      for (int y = 0; y < TC; ++y) dst[(i0 + x) * HD + j0 + y] = m[x][y];
  };
  float* out = (fwd ? ws_s : ws_g) + bh * n_u * HD * HD;
  fetch(fwd ? 0 : n_c - 1);
  put(0);
  __syncthreads();
  for (int64_t it = 0; it < n_c; ++it) {
    const int64_t c = fwd ? it : n_c - 1 - it;
    const int buf = it & 1;
    const int len =
        static_cast<int>(n_t - c * kBndT < kBndT ? n_t - c * kBndT : kBndT);
    if (it + 1 < n_c) fetch(fwd ? c + 1 : c - 1);
    // the state entering a unit, or the cotangent leaving it
    if (fwd ? (c * kBndT) % kStepUnit == 0
            : (c == n_c - 1 || ((c + 1) * kBndT) % kStepUnit == 0))
      keep(out + (c * kBndT / kStepUnit) * HD * HD);
    const auto& sa = sm[buf][0];
    const auto& sb = sm[buf][1];
    const auto& sw = sm[buf][2];
    if (fwd) {
      for (int t = 0; t < len; ++t) {
        float av[TR], wv[TR], bv[TC];
#pragma unroll
        for (int x = 0; x < TR; ++x) {
          av[x] = sa[t][i0 + x];
          wv[x] = sw[t][i0 + x];
        }
#pragma unroll
        for (int y = 0; y < TC; ++y) bv[y] = sb[t][j0 + y];
        // the step forward's roundings: kv in T, the update in float32
#pragma unroll
        for (int x = 0; x < TR; ++x)
#pragma unroll
          for (int y = 0; y < TC; ++y)
            m[x][y] = __fadd_rn(__fmul_rn(wv[x], m[x][y]),
                                rnd<T>(__fmul_rn(av[x], bv[y])));
      }
    } else {
      for (int t = len - 1; t >= 0; --t) {
        float av[TR], wv[TR], bv[TC];
#pragma unroll
        for (int x = 0; x < TR; ++x) {
          av[x] = sa[t][i0 + x];
          wv[x] = sw[t][i0 + x];
        }
#pragma unroll
        for (int y = 0; y < TC; ++y) bv[y] = sb[t][j0 + y];
#pragma unroll
        for (int x = 0; x < TR; ++x)
#pragma unroll
          for (int y = 0; y < TC; ++y)
            m[x][y] = fmaf(wv[x], m[x][y], av[x] * bv[y]);
      }
    }
    if (it + 1 < n_c) put(buf ^ 1);
    __syncthreads();
  }
  if (!fwd) keep(ds0 + bh * HD * HD);
}

// Pass 2's shape: a pair of rows and TC columns a thread, 16 lanes a pair
// of rows, kRows rows a group
template <int HD>
struct StepGrad {
  static constexpr int TC = HD / 16;
  static constexpr int kRows = HD < 32 ? HD : 32;
  static constexpr int kThreads = 8 * kRows;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kGroups = HD / kRows;
};

// pass 2's shared memory (above the 48 KB of a static allocation at hd 64:
// 67.3 KB)
template <int HD>
struct StepGradSm {
  float in[5][kStepUnit][HD];                       // r, k, v, w, dy
  float dvw[StepGrad<HD>::kWarps][kSub][HD];        // a warp's dv, a stretch
  float dv[kStepUnit][HD];                          // dv, summed over groups
  float out[3][kSub][StepGrad<HD>::kRows];          // dr, dw, dk, a stretch
  float u[HD];
};

// Pass 2, a block per (unit, batch x head): the unit's tokens staged, then
// for each group of rows, its stretches from the last: the states rebuilt
// from the one entering the unit, kept for the stretch, walked back from
// the cotangent leaving the unit.  dr, dw, dk and dv are written once; du
// leaves as a partial sum a (batch, unit) for colsum_kernel.
template <typename T, int HD>
__global__ void __launch_bounds__(StepGrad<HD>::kThreads)
rwkv6_step_grad_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ w,
                       const T* __restrict__ u, const T* __restrict__ dy,
                       const float* __restrict__ ws_s,
                       const float* __restrict__ ws_g, T* __restrict__ dr,
                       T* __restrict__ dk, T* __restrict__ dv,
                       T* __restrict__ dw, float* __restrict__ du_ws,
                       int64_t n_t, int64_t n_h) {
  using G = StepGrad<HD>;
  constexpr int TC = G::TC, kRows = G::kRows, kThr = G::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StepGradSm<HD>& sm = *reinterpret_cast<StepGradSm<HD>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l16 = tid & 15, rp = tid >> 4, j0 = l16 * TC;
  const int64_t unit = blockIdx.x, bh = blockIdx.y;
  const int64_t b = bh / n_h, h = bh % n_h;
  const int64_t stride = n_h * HD, base = (b * n_t * n_h + h) * HD;
  const int64_t n_u = (n_t + kStepUnit - 1) / kStepUnit;
  const int64_t t0 = unit * kStepUnit;
  const int len = static_cast<int>(n_t - t0 < kStepUnit ? n_t - t0
                                                        : kStepUnit);
  for (int e = tid; e < 5 * kStepUnit * HD; e += kThr) {
    const int arr = e / (kStepUnit * HD), c = e / HD % kStepUnit;
    const T* src = arr == 0   ? r
                   : arr == 1 ? k
                   : arr == 2 ? v
                   : arr == 3 ? w
                              : dy;
    (&sm.in[0][0][0])[e] =
        c < len ? act(src, base, stride, t0 + c, e % HD) : 0.f;
  }
  for (int i = tid; i < HD; i += kThr) sm.u[i] = to_f(u[h * HD + i]);
  __syncthreads();
  const auto& in_r = sm.in[0];
  const auto& in_k = sm.in[1];
  const auto& in_v = sm.in[2];
  const auto& in_w = sm.in[3];
  const auto& in_dy = sm.in[4];
  const float* unit_s = ws_s + (bh * n_u + unit) * HD * HD;
  const float* unit_g = ws_g + (bh * n_u + unit) * HD * HD;
  const int n_sub = (len + kSub - 1) / kSub;
  for (int grp = 0; grp < G::kGroups; ++grp) {
    const int i0 = grp * kRows + 2 * rp;  // the thread's rows i0, i0 + 1
    float g[2][TC], uu[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      uu[x] = sm.u[i0 + x];
#pragma unroll
      for (int y = 0; y < TC; ++y) g[x][y] = unit_g[(i0 + x) * HD + j0 + y];
    }
    float du_acc = 0.f;
    // one step forward of the thread's tile at token c of the unit, the
    // forward's roundings
    const auto step = [&](float (&st)[2][TC], int c) {
      float kk[2], ww[2], vv[TC];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        kk[x] = in_k[c][i0 + x];
        ww[x] = in_w[c][i0 + x];
      }
#pragma unroll
      for (int y = 0; y < TC; ++y) vv[y] = in_v[c][j0 + y];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < TC; ++y)
          st[x][y] = __fadd_rn(__fmul_rn(ww[x], st[x][y]),
                               rnd<T>(__fmul_rn(kk[x], vv[y])));
    };
    // the stretch of kSub tokens at sub * kSub; branch-free when whole
    // (so that the compiler can interleave its steps), guarded step by
    // step for the unit's short last one
    const auto stretch = [&](int sub, auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      float sp[kSub][2][TC];  // S_{t-1} of the stretch's tokens
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < TC; ++y)
          sp[0][x][y] = unit_s[(i0 + x) * HD + j0 + y];
      for (int c = 0; c < sub * kSub; ++c) step(sp[0], c);
#pragma unroll
      for (int c = 1; c < kSub; ++c) {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < TC; ++y) sp[c][x][y] = sp[c - 1][x][y];
        if (kWhole || sub * kSub + c - 1 < len) step(sp[c], sub * kSub + c - 1);
      }
#pragma unroll
      for (int c = kSub - 1; c >= 0; --c) {
        const int t = sub * kSub + c;
        if (!kWhole && t >= len) continue;
        float rr[2], kk[2], ww[2], vv[TC], dd[TC];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          rr[x] = in_r[t][i0 + x];
          kk[x] = in_k[t][i0 + x];
          ww[x] = in_w[t][i0 + x];
        }
#pragma unroll
        for (int y = 0; y < TC; ++y) {
          vv[y] = in_v[t][j0 + y];
          dd[y] = in_dy[t][j0 + y];
        }
        float p[8], dvp[TC];  // p[4x + q]: dr, dw, dk, du of row i0 + x
#pragma unroll
        for (int q = 0; q < 8; ++q) p[q] = 0.f;
#pragma unroll
        for (int y = 0; y < TC; ++y) dvp[y] = 0.f;
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < TC; ++y) {
            const float s = sp[c][x][y];
            const float kv = rnd<T>(__fmul_rn(kk[x], vv[y]));
            const float mm = rnd<T>(__fadd_rn(s, __fmul_rn(uu[x], kv)));
            const float dm = rr[x] * dd[y];
            const float dkv = fmaf(uu[x], dm, g[x][y]);
            p[4 * x] = fmaf(mm, dd[y], p[4 * x]);
            p[4 * x + 1] = fmaf(g[x][y], s, p[4 * x + 1]);
            p[4 * x + 2] = fmaf(dkv, vv[y], p[4 * x + 2]);
            p[4 * x + 3] = fmaf(dm, kv, p[4 * x + 3]);
            dvp[y] = fmaf(dkv, kk[x], dvp[y]);
            g[x][y] = fmaf(ww[x], g[x][y], dm);
          }
        // the sums over the row pair's 16 lanes: lane l16 ends with
        // p[l16 % 8] (row i0 + (l16 >> 2 & 1), quantity l16 & 3)
        float tot = reduce_scatter<8>(p, lane);
        tot += __shfl_xor_sync(0xffffffffu, tot, 8);
        if ((l16 & 3) == 3) {
          du_acc += tot;
        } else if (l16 < 8) {
          sm.out[l16 & 3][c][2 * rp + (l16 >> 2)] = tot;
        }
        // dv over the warp's two row pairs; the warps meet below
#pragma unroll
        for (int y = 0; y < TC; ++y)
          dvp[y] += __shfl_xor_sync(0xffffffffu, dvp[y], 16);
        if (lane < 16) {
#pragma unroll
          for (int y = 0; y < TC; ++y) sm.dvw[warp][c][j0 + y] = dvp[y];
        }
      }
    };
    for (int sub = n_sub - 1; sub >= 0; --sub) {
      if ((sub + 1) * kSub <= len) {
        stretch(sub, std::true_type{});
      } else {
        stretch(sub, std::false_type{});
      }
      __syncthreads();
      // dv over the warps in order (then over the groups in order); dr,
      // dw and dk of the group's rows out
      for (int e = tid; e < kSub * HD; e += kThr) {
        const int c = e / HD, j = e % HD, t = sub * kSub + c;
        if (t >= len) continue;
        float sum = 0.f;
#pragma unroll
        for (int wp = 0; wp < G::kWarps; ++wp) sum += sm.dvw[wp][c][j];
        sm.dv[t][j] = grp ? sm.dv[t][j] + sum : sum;
      }
      for (int e = tid; e < 3 * kSub * kRows; e += kThr) {
        const int q = e / (kSub * kRows), c = e / kRows % kSub;
        const int i = e % kRows, t = sub * kSub + c;
        if (t >= len) continue;
        T* dst = q == 0 ? dr : q == 1 ? dw : dk;
        dst[base + (t0 + t) * stride + grp * kRows + i] =
            from_f<T>(sm.out[q][c][i]);
      }
      __syncthreads();
    }
    if ((l16 & 11) == 3)  // du of rows i0 (l16 = 3) and i0 + 1 (l16 = 7)
      du_ws[(b * n_u + unit) * n_h * HD + h * HD + i0 + (l16 >> 2)] = du_acc;
  }
  for (int e = tid; e < len * HD; e += kThr)
    dv[base + (t0 + e / HD) * stride + e % HD] =
        from_f<T>(sm.dv[e / HD][e % HD]);
}

template <typename T, int HD>
cudaError_t fwd(const void* r, const void* k, const void* v, const void* w,
                const void* u, const float* s0, void* y, float* s_out,
                int64_t n_b, int64_t n_t, int64_t n_h, cudaStream_t st) {
  const auto rp = static_cast<const T*>(r), kp = static_cast<const T*>(k),
             vp = static_cast<const T*>(v), wp = static_cast<const T*>(w),
             up = static_cast<const T*>(u);
  if (n_t == 1) {  // decode
    rwkv6_fwd_kernel<T, HD><<<n_b * n_h, HD, 0, st>>>(
        rp, kp, vp, wp, up, s0, static_cast<T*>(y), s_out, n_t, n_h);
  } else {
    rwkv6_step_fwd_kernel<T, HD>
        <<<n_b * n_h, StepFwd<HD>::kThreads, 0, st>>>(
            rp, kp, vp, wp, up, s0, static_cast<T*>(y), s_out, n_t, n_h);
  }
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
          *up = static_cast<const T*>(u), *dyp = static_cast<const T*>(dy);
  const int64_t n_u = (n_t + kStepUnit - 1) / kStepUnit;
  const int64_t m = n_b * n_h * n_u * HD * HD;
  float* ws_s = ws;
  float* ws_g = ws_s + m;
  float* du_ws = ws_g + m;
  rwkv6_step_bound_kernel<T, HD>
      <<<dim3(n_b * n_h, 2), kBndThreads, 0, st>>>(
          rp, kp, vp, wp, dyp, s0, ds, ws_s, ws_g, ds0, n_t, n_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(StepGradSm<HD>));
  err = cudaFuncSetAttribute(rwkv6_step_grad_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  rwkv6_step_grad_kernel<T, HD>
      <<<dim3(n_u, n_b * n_h), StepGrad<HD>::kThreads, smem, st>>>(
          rp, kp, vp, wp, up, dyp, ws_s, ws_g, static_cast<T*>(dr),
          static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw),
          du_ws, n_t, n_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_kernel<<<(n_h * HD + 255) / 256, 256, 0, st>>>(du_ws, du, n_b * n_u,
                                                        n_h * HD);
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
// (2 * B*H*hd*hd + B*H*hd) * ceil(T / 32)); dr, dk, dv, dw, du (float32
// (H, hd)), ds0; B, T, H, hd; stream.  Any alignment, any T >= 1.
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
