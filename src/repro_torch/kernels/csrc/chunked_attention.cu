// chunked_attention: online-softmax attention over key tiles, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the device loop `jax.lax.scan` in `chunked_attention`,
// src/repro/models/layers.py:110 (no Pallas kernel: XLA runs the scan as
// one loop on the device).  Its step takes a chunk of 512 keys, writes
// the float32 scores of every query against it, and folds them into the
// running max m, the running sum l and the float32 accumulator.  The
// reference's model stack runs it on every attention without a KV cache:
// training, the enc-dec encoder, every cross-attention sublayer.
//
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] / sqrt(d)) v[b,h,j]
//
// over the keys j < tk, and j <= q_offset + i when causal (the mask
// aligns top-left, shifted by q_offset, unlike flash_attention.cu).  q is
// (B*H, tq, d), k and v (B*H, tk, d), d in {16, 64, 112, 128, 160} (every
// head width of the repo's configs).  Every row has
// a live key (tk >= 1, q_offset >= 0), so the reference's finite NEG_INF
// never decides a row's softmax, and a masked key adds exactly zero, as
// in the reference; here masked scores are -inf and fully masked key
// tiles are never loaded.  No score reaches device memory: the forward
// writes out and the per-row float32 log-sum-exp (natural log), which
// the backward uses to recompute the probabilities.
//
// Four kernels, each with a bfloat16 body on the tensor cores and a
// float32 body on the CUDA cores.  chunked_attention_head.cu takes every
// call at d 16 with at most 64 queries and 64 keys (the smoke configs'
// float32 attention, Jamba's bf16 smoke config), one launch a way; these
// bodies take float32 past that, and bf16 at d 16 past it or unaligned:
//   attn_fwd_kernel    a block per (b*h, 64-row query tile), key tiles
//                      through shared memory, m, l and the output in
//                      float32 registers;
//   attn_delta_kernel  D = rowsum(dO * O), a warp per row;
//   attn_bwd_kv_kernel a block per (b*h, key tile), looping over query
//                      tiles: dK and dV;
//   attn_bwd_q_kernel  a block per (b*h, query tile), looping over key
//                      tiles: dQ.
// The backward has no atomics: every gradient element is summed by one
// thread in a fixed order, so it is deterministic.
//
// bfloat16 bodies: four warps, each owning 16 rows; every product (QK^T
// and PV forward; K Q^T, V dO^T, P^T dO, dS^T Q and Q K^T, dO V^T, dS K
// backward) is mma.sync m16n8k16 with bf16 operands and float32
// accumulators, fed by ldmatrix (.trans for the operand stored k-major).
// A product's float32 result becomes the next product's A operand in
// registers (P and dS rounded to bf16, as the reference rounds p before
// its PV product); the scores stay unrounded (the reference rounds q.k to
// bf16), so the kernel stands closer to the float32 loop than the bf16
// loop does.  Exponentials are ex2.approx of scores scaled by log2(e).
//
// Bound: at the Whisper-medium encoder (B*H = 128, T = 1500, d = 64) a
// call does 73.7 GFLOP of products (0.075 ms at 989 TFLOP/s) and 288 M
// exponentials (0.085 ms at 16 a clock an SM at 1.98 GHz) on 74 MB (0.02
// ms at 3.35 TB/s): the exponentials and the products bound it, not the
// bytes.  mma.sync without a TMA / wgmma pipeline reaches a fraction of
// the tensor-core peak; the loads are synchronous (stage, sync, compute).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

#include "attn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;   // the launch bound of every kernel
constexpr int kTcThreads = 128;  // the bf16 bodies: four warps
constexpr int kTcM = 64;         // rows a bf16 block: 16 a warp
constexpr int kTcN = 64;         // keys (queries) a bf16 tile
constexpr int kTcKvQ = 32;       // queries a bf16 dK / dV step
constexpr int kSimtM = 64;       // query rows a float32 forward block
constexpr int kSimtN = 32;       // rows a float32 tile, elsewhere
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // backward: the forward's output
  const void* dout;   // backward: its cotangent
  void* out;          // forward: the output
  float* lse;         // (b*h, tq): written forward, read backward
  float* delta;       // (b*h, tq): rowsum(dO * O), backward
  void* dq;
  void* dk;
  void* dv;
  int64_t bh, tq, tk, q_offset, tiles;
  int causal;
  float scale;
};

__device__ __forceinline__ bool live(const Args& a, int64_t i, int64_t j) {
  return j < a.tk && (!a.causal || j <= i + a.q_offset);
}

// the keys [0, end) that rows [.., last] can see
__device__ __forceinline__ int64_t key_end(const Args& a, int64_t last) {
  if (!a.causal) return a.tk;
  const int64_t e = last + a.q_offset + 1;
  return e < a.tk ? e : a.tk;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// ---------------------------------------------------------------------------
// tensor-core helpers (bf16): attn_mma.cuh's, and the staging of a tile
// ---------------------------------------------------------------------------

using namespace attn_mma;

// rows [r0, r0 + ROWS) of a (n, D) bf16 matrix into a tile of row stride
// D + 8, 16 bytes a thread at a time, zero past row n
template <int D, int ROWS>
__device__ __forceinline__ void stage(bf16* s, const bf16* g, int64_t r0,
                                      int64_t n) {
  constexpr int kVec = D / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kVec; i += kTcThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) val = *reinterpret_cast<const uint4*>(g + (r0 + r) * D + c);
    *reinterpret_cast<uint4*>(s + r * (D + 8) + c) = val;
  }
}

// ---------------------------------------------------------------------------
// bf16 bodies
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_tc_smem() { return 3 * kTcM * (D + 8) * 2; }

template <int D>
__device__ __forceinline__ void fwd_tc(const Args& a, unsigned char* raw) {
  constexpr int LD = D + 8, kND = D / 8;
  bf16* qs = reinterpret_cast<bf16*>(raw);  // [kTcM][LD]
  bf16* ks = qs + kTcM * LD;                 // [kTcN][LD]
  bf16* vs = ks + kTcN * LD;                 // [kTcN][LD]
  const int64_t bh = blockIdx.x / a.tiles;
  const int64_t q0 = (blockIdx.x % a.tiles) * kTcM;
  const bf16* kg = static_cast<const bf16*>(a.k) + bh * a.tk * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + bh * a.tk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int64_t rows[2] = {q0 + warp * 16 + (lane >> 2),
                           q0 + warp * 16 + (lane >> 2) + 8};
  const float c = a.scale * kLog2e;

  stage<D, kTcM>(qs, static_cast<const bf16*>(a.q) + bh * a.tq * D, q0,
                 a.tq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) frag_a<LD>(qf[kk], qs, warp * 16,
                                                 kk * 16, lane);
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  const int64_t last = (q0 + kTcM < a.tq ? q0 + kTcM : a.tq) - 1;
  const int64_t k_end = key_end(a, last);
  for (int64_t k0 = 0; k0 < k_end; k0 += kTcN) {
    __syncthreads();  // the last tile's reads are done
    stage<D, kTcN>(ks, kg, k0, a.tk);
    stage<D, kTcN>(vs, vg, k0, a.tk);
    __syncthreads();
    float s[kTcN / 8][4];
#pragma unroll
    for (int j = 0; j < kTcN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < kTcN / 16; ++nn) {
        uint32_t b[4];
        frag_b_nk<LD>(b, ks, nn * 16, kk * 16, lane);
        mma(s[2 * nn], qf[kk], b[0], b[1]);
        mma(s[2 * nn + 1], qf[kk], b[2], b[3]);
      }
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kTcN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t col = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = live(a, rows[e >> 1], col) ? s[j][e] * c : -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with nothing live yet keeps l = 0 and o = 0
      base[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = ex2(m[r] - base[r]);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTcN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - base[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTcN / 16; ++kk) {
      uint32_t pa[4];
      to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b[4];
        frag_b_kn<LD>(b, vs, kk * 16, nd * 16, lane);
        mma(o[2 * nd], pa, b[0], b[1]);
        mma(o[2 * nd + 1], pa, b[2], b[3]);
      }
    }
  }

  bf16* og = static_cast<bf16*>(a.out) + bh * a.tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.tq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<uint32_t*>(og + rows[r] * D + n * 8 + 2 * t) =
          pack(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t == 0) a.lse[bh * a.tq + rows[r]] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// gradient columns a bf16 dK / dV block owns: at d = 160 the dK and dV
// accumulators of all columns (160 floats a thread) would spill, so two
// blocks take half the columns each (both recompute S and dP)
template <int D>
__host__ __device__ constexpr int kv_tc_cols() { return D == 160 ? D / 2 : D; }

template <int D>
constexpr int kv_tc_smem() {
  return (2 * kTcN + 2 * kTcKvQ) * (D + 8) * 2 + 2 * kTcKvQ * 4;
}

template <int D>
__device__ __forceinline__ void bwd_kv_tc(const Args& a, unsigned char* raw) {
  constexpr int C = kv_tc_cols<D>();  // gradient columns c0 .. c0 + C - 1
  constexpr int LD = D + 8, kND = C / 8;
  bf16* ks = reinterpret_cast<bf16*>(raw);  // [kTcN][LD]
  bf16* vs = ks + kTcN * LD;                 // [kTcN][LD]
  bf16* qs = vs + kTcN * LD;                 // [kTcKvQ][LD]
  bf16* dos = qs + kTcKvQ * LD;              // [kTcKvQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + kTcKvQ * LD);  // [kTcKvQ]
  float* del_s = lse_s + kTcKvQ;                               // [kTcKvQ]
  const int64_t block = blockIdx.x / (D / C);
  const int c0 = int(blockIdx.x % (D / C)) * C;
  const int64_t bh = block / a.tiles;
  const int64_t k0 = (block % a.tiles) * kTcN;
  const bf16* qg = static_cast<const bf16*>(a.q) + bh * a.tq * D;
  const bf16* dog = static_cast<const bf16*>(a.dout) + bh * a.tq * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int64_t keys[2] = {k0 + warp * 16 + (lane >> 2),
                           k0 + warp * 16 + (lane >> 2) + 8};
  const float c = a.scale * kLog2e;

  stage<D, kTcN>(ks, static_cast<const bf16*>(a.k) + bh * a.tk * D, k0,
                 a.tk);
  stage<D, kTcN>(vs, static_cast<const bf16*>(a.v) + bh * a.tk * D, k0,
                 a.tk);
  float dk[kND][4], dv[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // causal: query i sees key k0 first when i + q_offset >= k0
  int64_t i0 = 0;
  if (a.causal && k0 > a.q_offset) i0 = (k0 - a.q_offset) / kTcKvQ * kTcKvQ;
  for (; i0 < a.tq; i0 += kTcKvQ) {
    __syncthreads();
    stage<D, kTcKvQ>(qs, qg, i0, a.tq);
    stage<D, kTcKvQ>(dos, dog, i0, a.tq);
    if (threadIdx.x < kTcKvQ) {
      const int64_t i = i0 + threadIdx.x;
      lse_s[threadIdx.x] = i < a.tq ? a.lse[bh * a.tq + i] * kLog2e : 0.f;
      del_s[threadIdx.x] = i < a.tq ? a.delta[bh * a.tq + i] : 0.f;
    }
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kTcKvQ queries
    float st[kTcKvQ / 8][4], dpt[kTcKvQ / 8][4];
#pragma unroll
    for (int j = 0; j < kTcKvQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<LD>(ka, ks, warp * 16, kk * 16, lane);
      frag_a<LD>(va, vs, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < kTcKvQ / 16; ++nn) {
        uint32_t b[4];
        frag_b_nk<LD>(b, qs, nn * 16, kk * 16, lane);
        mma(st[2 * nn], ka, b[0], b[1]);
        mma(st[2 * nn + 1], ka, b[2], b[3]);
        frag_b_nk<LD>(b, dos, nn * 16, kk * 16, lane);
        mma(dpt[2 * nn], va, b[0], b[1]);
        mma(dpt[2 * nn + 1], va, b[2], b[3]);
      }
    }
    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < kTcKvQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = j * 8 + 2 * t + (e & 1);
        const int64_t i = i0 + il;
        const float p = i < a.tq && live(a, i, keys[e >> 1])
                            ? ex2(st[j][e] * c - lse_s[il])
                            : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - del_s[il]);
      }
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kTcKvQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      to_a(pa, st[2 * kk], st[2 * kk + 1]);
      to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < C / 16; ++nd) {
        uint32_t b[4];
        frag_b_kn<LD>(b, dos, kk * 16, c0 + nd * 16, lane);
        mma(dv[2 * nd], pa, b[0], b[1]);
        mma(dv[2 * nd + 1], pa, b[2], b[3]);
        frag_b_kn<LD>(b, qs, kk * 16, c0 + nd * 16, lane);
        mma(dk[2 * nd], da, b[0], b[1]);
        mma(dk[2 * nd + 1], da, b[2], b[3]);
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(a.dk) + bh * a.tk * D;
  bf16* dvg = static_cast<bf16*>(a.dv) + bh * a.tk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= a.tk) continue;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      const int64_t at = keys[r] * D + c0 + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkg + at) =
          pack(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvg + at) =
          pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
constexpr int q_tc_smem() { return 4 * kTcM * (D + 8) * 2; }

template <int D>
__device__ __forceinline__ void bwd_q_tc(const Args& a, unsigned char* raw) {
  constexpr int LD = D + 8, kND = D / 8;
  bf16* qs = reinterpret_cast<bf16*>(raw);  // [kTcM][LD]
  bf16* dos = qs + kTcM * LD;                // [kTcM][LD]
  bf16* ks = dos + kTcM * LD;                // [kTcN][LD]
  bf16* vs = ks + kTcN * LD;                 // [kTcN][LD]
  const int64_t bh = blockIdx.x / a.tiles;
  const int64_t q0 = (blockIdx.x % a.tiles) * kTcM;
  const bf16* kg = static_cast<const bf16*>(a.k) + bh * a.tk * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + bh * a.tk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int64_t rows[2] = {q0 + warp * 16 + (lane >> 2),
                           q0 + warp * 16 + (lane >> 2) + 8};
  const float c = a.scale * kLog2e;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < a.tq;
    lse2[r] = in ? a.lse[bh * a.tq + rows[r]] * kLog2e : 0.f;
    del[r] = in ? a.delta[bh * a.tq + rows[r]] : 0.f;
  }

  stage<D, kTcM>(qs, static_cast<const bf16*>(a.q) + bh * a.tq * D, q0,
                 a.tq);
  stage<D, kTcM>(dos, static_cast<const bf16*>(a.dout) + bh * a.tq * D, q0,
                 a.tq);
  float dq[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  const int64_t last = (q0 + kTcM < a.tq ? q0 + kTcM : a.tq) - 1;
  const int64_t k_end = key_end(a, last);
  for (int64_t k0 = 0; k0 < k_end; k0 += kTcN) {
    __syncthreads();
    stage<D, kTcN>(ks, kg, k0, a.tk);
    stage<D, kTcN>(vs, vg, k0, a.tk);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: this warp's 16 rows x kTcN keys
    float s[kTcN / 8][4], dp[kTcN / 8][4];
#pragma unroll
    for (int j = 0; j < kTcN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      frag_a<LD>(qa, qs, warp * 16, kk * 16, lane);
      frag_a<LD>(da, dos, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < kTcN / 16; ++nn) {
        uint32_t b[4];
        frag_b_nk<LD>(b, ks, nn * 16, kk * 16, lane);
        mma(s[2 * nn], qa, b[0], b[1]);
        mma(s[2 * nn + 1], qa, b[2], b[3]);
        frag_b_nk<LD>(b, vs, nn * 16, kk * 16, lane);
        mma(dp[2 * nn], da, b[0], b[1]);
        mma(dp[2 * nn + 1], da, b[2], b[3]);
      }
    }
    // dS = P (dP - D), into s
#pragma unroll
    for (int j = 0; j < kTcN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t col = k0 + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const float p = rows[r] < a.tq && live(a, rows[r], col)
                            ? ex2(s[j][e] * c - lse2[r])
                            : 0.f;
        s[j][e] = p * (dp[j][e] - del[r]);
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kTcN / 16; ++kk) {
      uint32_t sa[4];
      to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b[4];
        frag_b_kn<LD>(b, ks, kk * 16, nd * 16, lane);
        mma(dq[2 * nd], sa, b[0], b[1]);
        mma(dq[2 * nd + 1], sa, b[2], b[3]);
      }
    }
  }

  bf16* dqg = static_cast<bf16*>(a.dq) + bh * a.tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.tq) continue;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<uint32_t*>(dqg + rows[r] * D + n * 8 + 2 * t) =
          pack(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// float32 bodies (CUDA cores), 256 threads
// ---------------------------------------------------------------------------

// rows [r0, r0 + ROWS) of a (n, D) float32 matrix into a tile of row
// stride LDS, zero past row n
template <int D, int ROWS, int LDS>
__device__ __forceinline__ void stage_f(float* s, const float* g, int64_t r0,
                                        int64_t n) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, col = i % D;
    s[r * LDS + col] = r0 + r < n ? g[(r0 + r) * D + col] : 0.f;
  }
}

template <int D>
constexpr int fwd_simt_smem() {
  return ((kSimtM + kSimtN) * (D + 1) + kSimtN * D + kSimtM * (kSimtN + 1)) *
         4;
}

// 16 row groups of 4 rows x 16 column lanes: scores of rows ty*4+i,
// keys tx and tx+16; output columns tx + 16 c
template <int D>
__device__ __forceinline__ void fwd_simt(const Args& a, unsigned char* raw) {
  constexpr int kCols = D / 16;
  float* qs = reinterpret_cast<float*>(raw);  // [kSimtM][D + 1]
  float* ks = qs + kSimtM * (D + 1);           // [kSimtN][D + 1]
  float* vs = ks + kSimtN * (D + 1);           // [kSimtN][D]
  float* ps = vs + kSimtN * D;                 // [kSimtM][kSimtN + 1]
  const int64_t bh = blockIdx.x / a.tiles;
  const int64_t q0 = (blockIdx.x % a.tiles) * kSimtM;
  const float* kg = static_cast<const float*>(a.k) + bh * a.tk * D;
  const float* vg = static_cast<const float*>(a.v) + bh * a.tk * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage_f<D, kSimtM, D + 1>(qs, static_cast<const float*>(a.q) + bh * a.tq * D,
                            q0, a.tq);
  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int col = 0; col < kCols; ++col) o[i][col] = 0.f;
  }
  const int64_t last = (q0 + kSimtM < a.tq ? q0 + kSimtM : a.tq) - 1;
  const int64_t k_end = key_end(a, last);
  for (int64_t k0 = 0; k0 < k_end; k0 += kSimtN) {
    __syncthreads();
    stage_f<D, kSimtN, D + 1>(ks, kg, k0, a.tk);
    stage_f<D, kSimtN, D>(vs, vg, k0, a.tk);
    __syncthreads();
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int col = 0; col < D; ++col) {
      const float k0v = ks[tx * (D + 1) + col];
      const float k1v = ks[(tx + 16) * (D + 1) + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = qs[(ty * 4 + i) * (D + 1) + col];
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
        s[i][j] = live(a, row, k0 + tx + 16 * j) ? s[i][j] * a.scale
                                                 : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - base);
        sum += p;
        ps[(ty * 4 + i) * (kSimtN + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int col = 0; col < kCols; ++col) o[i][col] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kSimtN; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (kSimtN + 1) + j];
#pragma unroll
      for (int col = 0; col < kCols; ++col) {
        const float vv = vs[j * D + tx + 16 * col];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][col] = fmaf(pv[i], vv, o[i][col]);
      }
    }
  }

  float* og = static_cast<float*>(a.out) + bh * a.tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= a.tq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int col = 0; col < kCols; ++col)
      og[row * D + tx + 16 * col] = o[i][col] * inv;
    if (tx == 0) a.lse[bh * a.tq + row] = m[i] + logf(l[i]);
  }
}

template <int D>
constexpr int kv_simt_smem() {
  return (4 * kSimtN * (D + 1) + 2 * kSimtN * (kSimtN + 1) + 2 * kSimtN) * 4;
}

// thread (key ky = tid / 8, lane tx = tid % 8): scores against queries
// tx + 8 m, gradient columns tx + 8 m
template <int D>
__device__ __forceinline__ void bwd_kv_simt(const Args& a,
                                            unsigned char* raw) {
  constexpr int LDS = D + 1, kCols = D / 8;
  float* ks = reinterpret_cast<float*>(raw);  // [kSimtN][LDS]
  float* vs = ks + kSimtN * LDS;
  float* qs = vs + kSimtN * LDS;
  float* dos = qs + kSimtN * LDS;
  float* ps = dos + kSimtN * LDS;             // [kSimtN][kSimtN + 1]
  float* dss = ps + kSimtN * (kSimtN + 1);
  float* lse_s = dss + kSimtN * (kSimtN + 1);  // [kSimtN]
  float* del_s = lse_s + kSimtN;
  const int64_t bh = blockIdx.x / a.tiles;
  const int64_t k0 = (blockIdx.x % a.tiles) * kSimtN;
  const float* qg = static_cast<const float*>(a.q) + bh * a.tq * D;
  const float* dog = static_cast<const float*>(a.dout) + bh * a.tq * D;
  const int ky = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int64_t key = k0 + ky;

  stage_f<D, kSimtN, LDS>(ks, static_cast<const float*>(a.k) + bh * a.tk * D,
                          k0, a.tk);
  stage_f<D, kSimtN, LDS>(vs, static_cast<const float*>(a.v) + bh * a.tk * D,
                          k0, a.tk);
  float dk[kCols], dv[kCols];
#pragma unroll
  for (int col = 0; col < kCols; ++col) dk[col] = dv[col] = 0.f;
  int64_t i0 = 0;
  if (a.causal && k0 > a.q_offset) i0 = (k0 - a.q_offset) / kSimtN * kSimtN;
  for (; i0 < a.tq; i0 += kSimtN) {
    __syncthreads();
    stage_f<D, kSimtN, LDS>(qs, qg, i0, a.tq);
    stage_f<D, kSimtN, LDS>(dos, dog, i0, a.tq);
    if (threadIdx.x < kSimtN) {
      const int64_t i = i0 + threadIdx.x;
      lse_s[threadIdx.x] = i < a.tq ? a.lse[bh * a.tq + i] : 0.f;
      del_s[threadIdx.x] = i < a.tq ? a.delta[bh * a.tq + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kSimtN / 8; ++mm) {
      const int il = tx + 8 * mm;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int col = 0; col < D; ++col) {
        s = fmaf(ks[ky * LDS + col], qs[il * LDS + col], s);
        dp = fmaf(vs[ky * LDS + col], dos[il * LDS + col], dp);
      }
      const int64_t i = i0 + il;
      const float p = i < a.tq && live(a, i, key)
                          ? expf(s * a.scale - lse_s[il])
                          : 0.f;
      ps[ky * (kSimtN + 1) + il] = p;
      dss[ky * (kSimtN + 1) + il] = p * (dp - del_s[il]);
    }
    __syncthreads();
#pragma unroll 4
    for (int il = 0; il < kSimtN; ++il) {
      const float p = ps[ky * (kSimtN + 1) + il];
      const float ds = dss[ky * (kSimtN + 1) + il];
#pragma unroll
      for (int col = 0; col < kCols; ++col) {
        dv[col] = fmaf(p, dos[il * LDS + tx + 8 * col], dv[col]);
        dk[col] = fmaf(ds, qs[il * LDS + tx + 8 * col], dk[col]);
      }
    }
  }
  if (key >= a.tk) return;
  float* dkg = static_cast<float*>(a.dk) + (bh * a.tk + key) * D;
  float* dvg = static_cast<float*>(a.dv) + (bh * a.tk + key) * D;
#pragma unroll
  for (int col = 0; col < kCols; ++col) {
    dkg[tx + 8 * col] = dk[col] * a.scale;
    dvg[tx + 8 * col] = dv[col];
  }
}

template <int D>
constexpr int q_simt_smem() {
  return (4 * kSimtN * (D + 1) + kSimtN * (kSimtN + 1)) * 4;
}

// thread (row qy = tid / 8, lane tx = tid % 8): scores against keys
// tx + 8 m, gradient columns tx + 8 m
template <int D>
__device__ __forceinline__ void bwd_q_simt(const Args& a, unsigned char* raw) {
  constexpr int LDS = D + 1, kCols = D / 8;
  float* qs = reinterpret_cast<float*>(raw);  // [kSimtN][LDS]
  float* dos = qs + kSimtN * LDS;
  float* ks = dos + kSimtN * LDS;
  float* vs = ks + kSimtN * LDS;
  float* dss = vs + kSimtN * LDS;             // [kSimtN][kSimtN + 1]
  const int64_t bh = blockIdx.x / a.tiles;
  const int64_t q0 = (blockIdx.x % a.tiles) * kSimtN;
  const float* kg = static_cast<const float*>(a.k) + bh * a.tk * D;
  const float* vg = static_cast<const float*>(a.v) + bh * a.tk * D;
  const int qy = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int64_t row = q0 + qy;
  const bool in = row < a.tq;
  const float lse = in ? a.lse[bh * a.tq + row] : 0.f;
  const float del = in ? a.delta[bh * a.tq + row] : 0.f;

  stage_f<D, kSimtN, LDS>(qs, static_cast<const float*>(a.q) + bh * a.tq * D,
                          q0, a.tq);
  stage_f<D, kSimtN, LDS>(
      dos, static_cast<const float*>(a.dout) + bh * a.tq * D, q0, a.tq);
  float dq[kCols];
#pragma unroll
  for (int col = 0; col < kCols; ++col) dq[col] = 0.f;
  const int64_t last = (q0 + kSimtN < a.tq ? q0 + kSimtN : a.tq) - 1;
  const int64_t k_end = key_end(a, last);
  for (int64_t k0 = 0; k0 < k_end; k0 += kSimtN) {
    __syncthreads();
    stage_f<D, kSimtN, LDS>(ks, kg, k0, a.tk);
    stage_f<D, kSimtN, LDS>(vs, vg, k0, a.tk);
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kSimtN / 8; ++mm) {
      const int jl = tx + 8 * mm;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int col = 0; col < D; ++col) {
        s = fmaf(qs[qy * LDS + col], ks[jl * LDS + col], s);
        dp = fmaf(dos[qy * LDS + col], vs[jl * LDS + col], dp);
      }
      const float p = in && live(a, row, k0 + jl)
                          ? expf(s * a.scale - lse)
                          : 0.f;
      dss[qy * (kSimtN + 1) + jl] = p * (dp - del);
    }
    __syncthreads();
#pragma unroll 4
    for (int jl = 0; jl < kSimtN; ++jl) {
      const float ds = dss[qy * (kSimtN + 1) + jl];
#pragma unroll
      for (int col = 0; col < kCols; ++col)
        dq[col] = fmaf(ds, ks[jl * LDS + tx + 8 * col], dq[col]);
    }
  }
  if (!in) return;
  float* dqg = static_cast<float*>(a.dq) + (bh * a.tq + row) * D;
#pragma unroll
  for (int col = 0; col < kCols; ++col) dqg[tx + 8 * col] = dq[col] * a.scale;
}

// ---------------------------------------------------------------------------
// the four kernels
// ---------------------------------------------------------------------------

template <typename T>
constexpr bool kTc = std::is_same<T, bf16>::value;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kTc<T>) fwd_tc<D>(a, smem);
  else fwd_simt<D>(a, smem);
}

// D = rowsum(dO * O) in float32, a warp per row
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_delta_kernel(Args a) {
  const int64_t row = int64_t(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= a.bh * a.tq) return;
  const T* o = static_cast<const T*>(a.o) + row * D;
  const T* dout = static_cast<const T*>(a.dout) + row * D;
  float acc = 0.f;
  for (int col = threadIdx.x % 32; col < D; col += 32)
    acc = fmaf(to_f(o[col]), to_f(dout[col]), acc);
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) a.delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_kv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kTc<T>) bwd_kv_tc<D>(a, smem);
  else bwd_kv_simt<D>(a, smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_q_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kTc<T>) bwd_q_tc<D>(a, smem);
  else bwd_q_simt<D>(a, smem);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Launch `kern` on `blocks` blocks; above 48 KB of shared memory only
// after the opt-in, set once per device and instantiation (so on the
// first call, not inside a graph capture).
template <typename K>
int launch(K kern, bool (&opted)[kMaxDevices], int64_t blocks, int threads,
           int smem, const Args& a, void* stream) {
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && !opted[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return int(err);
    opted[dev] = true;
  }
  kern<<<unsigned(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return int(cudaGetLastError());
}

template <typename T, int D>
int forward(Args a, void* stream) {
  static bool opted[kMaxDevices] = {};
  const int rows = kTc<T> ? kTcM : kSimtM;
  a.tiles = (a.tq + rows - 1) / rows;
  return launch(attn_fwd_kernel<T, D>, opted, a.bh * a.tiles,
                kTc<T> ? kTcThreads : kThreads,
                kTc<T> ? fwd_tc_smem<D>() : fwd_simt_smem<D>(), a, stream);
}

template <typename T, int D>
int backward(Args a, void* stream) {
  static bool opted_delta[kMaxDevices] = {}, opted_kv[kMaxDevices] = {},
              opted_q[kMaxDevices] = {};
  int err = launch(attn_delta_kernel<T, D>, opted_delta,
                   (a.bh * a.tq + kThreads / 32 - 1) / (kThreads / 32),
                   kThreads, 0, a, stream);
  if (err) return err;
  const int threads = kTc<T> ? kTcThreads : kThreads;
  const int keys = kTc<T> ? kTcN : kSimtN;
  Args kv = a;
  kv.tiles = (a.tk + keys - 1) / keys;
  const int64_t parts = kTc<T> ? D / kv_tc_cols<D>() : 1;
  err = launch(attn_bwd_kv_kernel<T, D>, opted_kv, a.bh * kv.tiles * parts,
               threads,
               kTc<T> ? kv_tc_smem<D>() : kv_simt_smem<D>(), kv, stream);
  if (err) return err;
  const int rows = kTc<T> ? kTcM : kSimtN;
  Args qa = a;
  qa.tiles = (a.tq + rows - 1) / rows;
  return launch(attn_bwd_q_kernel<T, D>, opted_q, a.bh * qa.tiles, threads,
                kTc<T> ? q_tc_smem<D>() : q_simt_smem<D>(), qa, stream);
}

Args make_args(const void* q, const void* k, const void* v, int64_t bh,
               int64_t tq, int64_t tk, int64_t d, int64_t causal,
               int64_t q_offset) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bh = bh;
  a.tq = tq;
  a.tk = tk;
  a.q_offset = q_offset;
  a.causal = causal != 0;
  a.scale = 1.0f / sqrtf(float(d));
  return a;
}

template <typename T>
int forward_d(const Args& a, int64_t d, void* stream) {
  if (d == 16) return forward<T, 16>(a, stream);
  if (d == 64) return forward<T, 64>(a, stream);
  if (d == 112) return forward<T, 112>(a, stream);
  if (d == 128) return forward<T, 128>(a, stream);
  if (d == 160) return forward<T, 160>(a, stream);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int backward_d(const Args& a, int64_t d, void* stream) {
  if (d == 16) return backward<T, 16>(a, stream);
  if (d == 64) return backward<T, 64>(a, stream);
  if (d == 112) return backward<T, 112>(a, stream);
  if (d == 128) return backward<T, 128>(a, stream);
  if (d == 160) return backward<T, 160>(a, stream);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* out,
              void* lse, long long bh, long long tq, long long tk,
              long long d, long long causal, long long q_offset,
              void* stream) {
  if (tk < 1 || q_offset < 0) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, bh, tq, tk, d, causal, q_offset);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  return forward_d<T>(a, d, stream);
}

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              void* dk, void* dv, long long bh, long long tq, long long tk,
              long long d, long long causal, long long q_offset,
              void* stream) {
  if (tk < 1 || q_offset < 0) return int(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, bh, tq, tk, d, causal, q_offset);
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  return backward_d<T>(a, d, stream);
}

}  // namespace

// q, k, v, out, lse; B*H, tq, tk, d, causal, q_offset; stream
extern "C" int chunked_attention_fwd_f32(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         long long bh, long long tq,
                                         long long tk, long long d,
                                         long long causal,
                                         long long q_offset, void* stream) {
  return fwd_entry<float>(q, k, v, out, lse, bh, tq, tk, d, causal, q_offset,
                          stream);
}

extern "C" int chunked_attention_fwd_bf16(const void* q, const void* k,
                                          const void* v, void* out, void* lse,
                                          long long bh, long long tq,
                                          long long tk, long long d,
                                          long long causal,
                                          long long q_offset, void* stream) {
  return fwd_entry<bf16>(q, k, v, out, lse, bh, tq, tk, d, causal, q_offset,
                         stream);
}

// q, k, v, out, dout, lse, delta (workspace, B*H*tq float32), dq, dk, dv;
// B*H, tq, tk, d, causal, q_offset; stream
extern "C" int chunked_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, long long bh, long long tq, long long tk, long long d,
    long long causal, long long q_offset, void* stream) {
  return bwd_entry<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, tq,
                          tk, d, causal, q_offset, stream);
}

extern "C" int chunked_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, long long bh, long long tq, long long tk, long long d,
    long long causal, long long q_offset, void* stream) {
  return bwd_entry<bf16>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, tq,
                         tk, d, causal, q_offset, stream);
}
