// chunked_attention_head: attention over a whole head in one block, forward
// and backward one launch each, for Hopper (sm_90a), at head width 16 with
// at most 64 queries and 64 keys.
//
// Replaces, at those shapes, the device loop `jax.lax.scan` in
// `chunked_attention`, src/repro/models/layers.py:110, as
// chunked_attention.cu does at every shape, and computes what that file's
// kernels compute: the same top-left causal mask shifted by q_offset
// (key j counts for query i iff j < tk and, causal, j <= q_offset + i),
// out in q's dtype and the per-row float32 log-sum-exp in natural log,
// which any backward route reads.  q, out are (B*H, tq, 16), k, v (B*H,
// tk, 16), each contiguous from a 16-byte boundary.  These are the smoke
// configs' float32 attention (2 x 4 heads of 16 x 16 to 24 tokens) and
// Jamba's bf16 smoke config (2 x 4 x 64 x 64).
//
// Bound.  At the float32 smoke shape (B*H = 8, T = 16) a forward moves
// 17 KB and a backward 33 KB: 0.005 and 0.010 us at 3.35 TB/s, and a few
// hundred thousand FMAs.  No such call approaches its bound: the time is
// the launch, one round trip to device memory and the chain of dependent
// steps in the block.  chunked_attention.cu's bodies spend it on stages
// that wait for each other: a 64-row block with 48 rows idle, key tiles
// staged, synchronised and computed in turn, and a backward of three
// launches (D, then dK and dV, then dQ), each loading q, k and v again.
//
// Design: one block a (b, h) head, one launch a way.  Thread 0 starts a
// cp.async.bulk (TMA's 1-D bulk copy) of each operand's contiguous range
// (q, k, v; the backward also o and dO) into shared memory, all
// completing on one mbarrier, so every byte of the head is in flight in
// one round trip; meanwhile the threads zero the tiles' rows past tq or
// tk that a loop or product reads (they read whole 16-row tiles) and the
// backward reads its rows' log-sum-exp.  A causal backward warp skips
// the 16-key (16-query) tiles its rows cannot see; the forward computes
// every tile (skipping them was slower there).  The block is sized to
// the head, and the backward computes D = rowsum(dO * O) itself: no
// workspace.  Every
// gradient element is summed by one thread in a fixed order, no atomics,
// so two runs are bitwise equal.  Shared memory stays under the 48 KB a
// launch takes without an opt-in (head_smem_bytes in
// chunked_attention.py), so a launch inside a graph capture needs none.
//
// bf16 bodies: a warp per 16 rows, the products on mma.sync m16n8k16
// with float32 accumulators fed by ldmatrix, as chunked_attention.cu's
// bf16 bodies with every key in one tile: S = Q K^T unrounded, p =
// ex2(S log2(e) / sqrt(d) - m), P rounded to bf16 for P V.  The backward
// has a warp per 16 query rows (S, dP = dO V^T, dS = P (dP - D), dQ =
// dS K) beside a warp per 16 key rows (S^T = K Q^T, dP^T = V dO^T, dV =
// P^T dO, dK = dS^T Q), the two sets at once, each recomputing the
// scores its way instead of a round trip through shared memory; D and
// lse log2(e) of every row sit in shared memory.  The backward computes
// every exponential and then selects: a branch around each serialised
// them.
//
// float32 bodies: exact float32 FMAs on the CUDA cores (no TF32), a
// half-warp a row.  Forward: lane l of row i scores keys l, l + 16, ..,
// takes the row's max and sum by shuffles, and owns output column l; the
// probabilities reach the lanes by shuffles, not shared memory.
// Backward: a half-warp a key recomputes p and dS against every query
// (lane l takes queries l, l + 16, ..), sums dV and dK of its key (lane l
// column l) from the shuffled p and dS, and writes dS to shared memory,
// from which a half-warp a query then sums dQ.  Dot products start at
// column l, so the 16 lanes of a half-warp read 16 banks; the sums over
// keys or queries run a whole 16-row tile at a time, even and odd rows
// in two accumulators, so their loads and shuffles issue ahead of the
// FMAs.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

#include "attn_mma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace attn_mma;

constexpr int kD = 16;         // the head width
constexpr int kMaxT = 64;      // the most queries and keys of a head
constexpr int kSmemLimit = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
constexpr bool kTc = std::is_same<T, bf16>::value;

// the largest block: a warp per 16 queries, and in the backward also a
// warp per 16 keys (bf16); a half-warp for each of 64 rows (float32)
template <typename T, bool kBwd>
constexpr int max_threads() {
  return kTc<T> ? (kBwd ? 2 : 1) * kMaxT / 16 * 32 : kMaxT * 16;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // backward: the forward's output
  const void* dout;  // backward: its cotangent
  void* out;         // forward: the output
  float* lse;        // (b*h, tq): written forward, read backward
  void* dq;
  void* dk;
  void* dv;
  int64_t q_offset;
  int tq, tk, causal;
  float scale;
};

__device__ __forceinline__ bool live(const Args& a, int i, int j) {
  return j < a.tk && (!a.causal || j <= i + a.q_offset);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets in shared memory: the mbarrier (16 bytes), then q, k, v,
// and for the backward o, dO, lse (log2(e) scaled for bf16) and D of
// every row, and the float32 backward's dS (tq x (rk + 1)).  The tiles
// take whole 16-row tiles (rq, rk rows), the rows past tq or tk zeroed
// where a product reads them, so the loops run over whole tiles without
// a test a row.  chunked_attention.head_smem_bytes is the backward's
// total.
struct Layout {
  int q, k, v, o, dout, lse, delta, ds, bytes;
};

template <typename T>
__host__ __device__ Layout layout(int tq, int tk, bool bwd) {
  const int rq = round16(tq), rk = round16(tk);
  const int row = kD * int(sizeof(T));
  Layout L{};
  int at = 16;
  L.q = at;
  at += rq * row;
  L.k = at;
  at += rk * row;
  L.v = at;
  at += rk * row;
  if (bwd) {
    L.o = at;
    at += rq * row;
    L.dout = at;
    at += rq * row;
    L.lse = at;
    at += rq * 4;
    L.delta = at;
    at += rq * 4;
    if (!kTc<T>) {
      L.ds = at;
      at += tq * (rk + 1) * 4;
    }
  }
  L.bytes = at;
  return L;
}

// Thread 0: the mbarrier at the start of shared memory, expecting the
// bytes of N ranges of rows, and a bulk copy of each range (`rows[i]`
// rows from global `src[i]`) to its offset `dst[i]`, completing on it.
template <typename T, int N>
__device__ __forceinline__ void start_loads(unsigned char* smem,
                                            const void* const (&src)[N],
                                            const int (&dst)[N],
                                            const int (&rows)[N]) {
  if (threadIdx.x != 0) return;
  const uint32_t bar = hopper::smem_addr(smem);
  hopper::mbar_init(bar, 1);
  hopper::fence_mbar_init();
  uint32_t total = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) total += uint32_t(rows[i]) * kD * sizeof(T);
  hopper::mbar_expect_tx(bar, total);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (rows[i] > 0)
      hopper::bulk_load(hopper::smem_addr(smem + dst[i]), src[i],
                        uint32_t(rows[i]) * kD * sizeof(T), bar);
}

// Zero rows [n, round16(n)) of a tile of T at `s`, 16 bytes a thread at
// a time
template <typename T>
__device__ __forceinline__ void zero_tail(unsigned char* s, int n) {
  constexpr int kRow = kD * int(sizeof(T));
  uint4* p = reinterpret_cast<uint4*>(s + n * kRow);
  for (int i = threadIdx.x; i < (round16(n) - n) * kRow / 16;
       i += blockDim.x)
    p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The 16-key (or 16-query) tiles a causal warp's 16 rows from r0 on can
// see: [0, n) of n tiles
__device__ __forceinline__ int tiles_seen(const Args& a, int r0, int n) {
  if (!a.causal) return n;
  const int64_t e = (r0 + 16 + a.q_offset + 15) / 16;
  return e < n ? int(e) : n;
}

// The first 16-query tile that can see a causal warp's 16 keys from r0 on
__device__ __forceinline__ int first_tile_seeing(const Args& a, int r0) {
  if (!a.causal || r0 <= a.q_offset) return 0;
  return int((r0 - a.q_offset) / 16);
}

// ---------------------------------------------------------------------------
// bf16 bodies (mma.sync), a warp per 16 rows
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fwd_tc(const Args& a, unsigned char* smem) {
  const Layout L = layout<bf16>(a.tq, a.tk, false);
  const int64_t bh = blockIdx.x;
  {
    const void* const src[3] = {
        static_cast<const bf16*>(a.q) + bh * a.tq * kD,
        static_cast<const bf16*>(a.k) + bh * a.tk * kD,
        static_cast<const bf16*>(a.v) + bh * a.tk * kD};
    const int dst[3] = {L.q, L.k, L.v};
    const int rows[3] = {a.tq, a.tk, a.tk};
    start_loads<bf16>(smem, src, dst, rows);
  }
  zero_tail<bf16>(smem + L.q, a.tq);
  zero_tail<bf16>(smem + L.k, a.tk);
  zero_tail<bf16>(smem + L.v, a.tk);
  __syncthreads();
  hopper::mbar_wait(hopper::smem_addr(smem), 0);

  const bf16* qs = reinterpret_cast<const bf16*>(smem + L.q);
  const bf16* ks = reinterpret_cast<const bf16*>(smem + L.k);
  const bf16* vs = reinterpret_cast<const bf16*>(smem + L.v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, nk = round16(a.tk) / 16;
  const int rows[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const float c = a.scale * kLog2e;

  uint32_t qf[4];
  frag_a<kD>(qf, qs, warp * 16, 0, lane);
  float s[kMaxT / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int nn = 0; nn < kMaxT / 16; ++nn) {
    if (nn < nk) {
      uint32_t b[4];
      frag_b_nk<kD>(b, ks, nn * 16, 0, lane);
      mma(s[2 * nn], qf, b[0], b[1]);
      mma(s[2 * nn + 1], qf, b[2], b[3]);
    }
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < kMaxT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + 2 * t + (e & 1);
      s[j][e] = live(a, rows[e >> 1], col) ? s[j][e] * c : -CUDART_INF_F;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    if (mx[r] == -CUDART_INF_F) mx[r] = 0.f;  // a padding row: p = 0
  }
#pragma unroll
  for (int j = 0; j < kMaxT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = ex2(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
  }
  float o[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxT / 16; ++kk) {
    if (kk < nk) {
      uint32_t pa[4], b[4];
      to_a(pa, s[2 * kk], s[2 * kk + 1]);
      frag_b_kn<kD>(b, vs, kk * 16, 0, lane);
      mma(o[0], pa, b[0], b[1]);
      mma(o[1], pa, b[2], b[3]);
    }
  }

  bf16* og = static_cast<bf16*>(a.out) + bh * a.tq * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.tq) continue;
    const float inv = sum[r] > 0.f ? 1.f / sum[r] : 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      *reinterpret_cast<uint32_t*>(og + rows[r] * kD + n * 8 + 2 * t) =
          pack(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t == 0) a.lse[bh * a.tq + rows[r]] = (mx[r] + log2f(sum[r])) * kLn2;
  }
}

__device__ __forceinline__ void bwd_tc(const Args& a, unsigned char* smem) {
  const Layout L = layout<bf16>(a.tq, a.tk, true);
  const int64_t bh = blockIdx.x;
  const int rq = round16(a.tq), rk = round16(a.tk);
  {
    const void* const src[5] = {
        static_cast<const bf16*>(a.q) + bh * a.tq * kD,
        static_cast<const bf16*>(a.k) + bh * a.tk * kD,
        static_cast<const bf16*>(a.v) + bh * a.tk * kD,
        static_cast<const bf16*>(a.o) + bh * a.tq * kD,
        static_cast<const bf16*>(a.dout) + bh * a.tq * kD};
    const int dst[5] = {L.q, L.k, L.v, L.o, L.dout};
    const int rows[5] = {a.tq, a.tk, a.tk, a.tq, a.tq};
    start_loads<bf16>(smem, src, dst, rows);
  }
  zero_tail<bf16>(smem + L.q, a.tq);
  zero_tail<bf16>(smem + L.k, a.tk);
  zero_tail<bf16>(smem + L.v, a.tk);
  zero_tail<bf16>(smem + L.dout, a.tq);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* del_s = reinterpret_cast<float*>(smem + L.delta);
  const int i = threadIdx.x;  // the row whose D and lse this thread sets
  const float lse_i = i < a.tq ? a.lse[bh * a.tq + i] : 0.f;
  __syncthreads();
  hopper::mbar_wait(hopper::smem_addr(smem), 0);

  const bf16* qs = reinterpret_cast<const bf16*>(smem + L.q);
  const bf16* ks = reinterpret_cast<const bf16*>(smem + L.k);
  const bf16* vs = reinterpret_cast<const bf16*>(smem + L.v);
  const bf16* dos = reinterpret_cast<const bf16*>(smem + L.dout);
  if (i < rq) {
    float acc = 0.f;
    if (i < a.tq) {
      const uint4* orow = reinterpret_cast<const uint4*>(smem + L.o) + 2 * i;
      const uint4* drow = reinterpret_cast<const uint4*>(dos) + 2 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 ov = orow[h], dv = drow[h];
        const bf16* ob = reinterpret_cast<const bf16*>(&ov);
        const bf16* db = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(ob[e]), __bfloat162float(db[e]), acc);
      }
    }
    del_s[i] = acc;
    lse_s[i] = lse_i * kLog2e;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, nq = rq / 16;
  const float c = a.scale * kLog2e;
  if (warp < nq) {
    // dQ of query rows r0..: S = Q K^T, dP = dO V^T, dS = P (dP - D),
    // dQ = dS K, over the key tiles the rows see
    const int r0 = warp * 16;
    const int nk = tiles_seen(a, r0, rk / 16);
    const int rows[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
    uint32_t qa[4], da[4];
    frag_a<kD>(qa, qs, r0, 0, lane);
    frag_a<kD>(da, dos, r0, 0, lane);
    float s[kMaxT / 8][4], dp[kMaxT / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int nn = 0; nn < kMaxT / 16; ++nn) {
      if (nn < nk) {
        uint32_t b[4];
        frag_b_nk<kD>(b, ks, nn * 16, 0, lane);
        mma(s[2 * nn], qa, b[0], b[1]);
        mma(s[2 * nn + 1], qa, b[2], b[3]);
        frag_b_nk<kD>(b, vs, nn * 16, 0, lane);
        mma(dp[2 * nn], da, b[0], b[1]);
        mma(dp[2 * nn + 1], da, b[2], b[3]);
      }
    }
    const float lse2[2] = {lse_s[rows[0]], lse_s[rows[1]]};
    const float del[2] = {del_s[rows[0]], del_s[rows[1]]};
#pragma unroll
    for (int j = 0; j < kMaxT / 8; ++j) {
      if (j < 2 * nk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // the exponential of every element, then a select: no branch
          const int r = e >> 1, col = j * 8 + 2 * t + (e & 1);
          const float ex = ex2(s[j][e] * c - lse2[r]);
          const float p = rows[r] < a.tq && live(a, rows[r], col) ? ex : 0.f;
          s[j][e] = p * (dp[j][e] - del[r]);
        }
      }
    }
    float dq[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxT / 16; ++kk) {
      if (kk < nk) {
        uint32_t sa[4], b[4];
        to_a(sa, s[2 * kk], s[2 * kk + 1]);
        frag_b_kn<kD>(b, ks, kk * 16, 0, lane);
        mma(dq[0], sa, b[0], b[1]);
        mma(dq[1], sa, b[2], b[3]);
      }
    }
    bf16* dqg = static_cast<bf16*>(a.dq) + bh * a.tq * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= a.tq) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
        *reinterpret_cast<uint32_t*>(dqg + rows[r] * kD + n * 8 + 2 * t) =
            pack(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
    }
  } else {
    // dK and dV of key rows r0..: S^T = K Q^T, dP^T = V dO^T, dV = P^T dO,
    // dK = dS^T Q, over the query tiles [q0, nq) that see the keys
    const int r0 = (warp - nq) * 16;
    const int q0 = first_tile_seeing(a, r0);
    const int keys[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
    uint32_t ka[4], va[4];
    frag_a<kD>(ka, ks, r0, 0, lane);
    frag_a<kD>(va, vs, r0, 0, lane);
    float st[kMaxT / 8][4], dpt[kMaxT / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int nn = 0; nn < kMaxT / 16; ++nn) {
      if (nn >= q0 && nn < nq) {
        uint32_t b[4];
        frag_b_nk<kD>(b, qs, nn * 16, 0, lane);
        mma(st[2 * nn], ka, b[0], b[1]);
        mma(st[2 * nn + 1], ka, b[2], b[3]);
        frag_b_nk<kD>(b, dos, nn * 16, 0, lane);
        mma(dpt[2 * nn], va, b[0], b[1]);
        mma(dpt[2 * nn + 1], va, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxT / 8; ++j) {
      if (j >= 2 * q0 && j < 2 * nq) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = j * 8 + 2 * t + (e & 1);
          const float ex = ex2(st[j][e] * c - lse_s[il]);
          const float p = il < a.tq && live(a, il, keys[e >> 1]) ? ex : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - del_s[il]);
        }
      }
    }
    float dk[2][4], dv[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxT / 16; ++kk) {
      if (kk >= q0 && kk < nq) {
        uint32_t pa[4], sa[4], b[4];
        to_a(pa, st[2 * kk], st[2 * kk + 1]);
        to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
        frag_b_kn<kD>(b, dos, kk * 16, 0, lane);
        mma(dv[0], pa, b[0], b[1]);
        mma(dv[1], pa, b[2], b[3]);
        frag_b_kn<kD>(b, qs, kk * 16, 0, lane);
        mma(dk[0], sa, b[0], b[1]);
        mma(dk[1], sa, b[2], b[3]);
      }
    }
    bf16* dkg = static_cast<bf16*>(a.dk) + bh * a.tk * kD;
    bf16* dvg = static_cast<bf16*>(a.dv) + bh * a.tk * kD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (keys[r] >= a.tk) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int at = keys[r] * kD + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkg + at) =
            pack(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvg + at) =
            pack(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 bodies (CUDA cores), a half-warp a row
// ---------------------------------------------------------------------------

// x . y over the 16 columns, from column l on
__device__ __forceinline__ float dot16(const float* x, const float* y, int l) {
  float acc = 0.f;
#pragma unroll
  for (int col = 0; col < kD; ++col) {
    const int cc = (col + l) & (kD - 1);
    acc = fmaf(x[cc], y[cc], acc);
  }
  return acc;
}

__device__ __forceinline__ void fwd_simt(const Args& a, unsigned char* smem) {
  const Layout L = layout<float>(a.tq, a.tk, false);
  const int64_t bh = blockIdx.x;
  {
    const void* const src[3] = {
        static_cast<const float*>(a.q) + bh * a.tq * kD,
        static_cast<const float*>(a.k) + bh * a.tk * kD,
        static_cast<const float*>(a.v) + bh * a.tk * kD};
    const int dst[3] = {L.q, L.k, L.v};
    const int rows[3] = {a.tq, a.tk, a.tk};
    start_loads<float>(smem, src, dst, rows);
  }
  zero_tail<float>(smem + L.v, a.tk);
  __syncthreads();
  hopper::mbar_wait(hopper::smem_addr(smem), 0);

  const float* qs = reinterpret_cast<const float*>(smem + L.q);
  const float* ks = reinterpret_cast<const float*>(smem + L.k);
  const float* vs = reinterpret_cast<const float*>(smem + L.v);
  const int i = threadIdx.x >> 4, l = threadIdx.x & 15;
  const bool in = i < a.tq;
  const float* qr = qs + (in ? i : 0) * kD;
  // lane l scores keys l + 16 m
  float p[kMaxT / 16];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < kMaxT / 16; ++m) {
    const int j = l + 16 * m;
    p[m] = -CUDART_INF_F;
    if (j < a.tk && live(a, i, j)) p[m] = dot16(qr, ks + j * kD, l) * a.scale;
    mx = fmaxf(mx, p[m]);
  }
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
  if (mx == -CUDART_INF_F) mx = 0.f;  // a padding row: p = 0
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxT / 16; ++m) {
    if (16 * m < a.tk) {
      p[m] = expf(p[m] - mx);
      sum += p[m];
    }
  }
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(kFull, sum, w);
  // output column l, a 16-key tile at a time: the keys' probabilities
  // from the lanes that hold them (0 past tk, where v is zero), even and
  // odd keys in two sums
  float o[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < kMaxT / 16; ++m) {
    if (16 * m < a.tk) {
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        o[jj & 1] = fmaf(__shfl_sync(kFull, p[m], jj, 16),
                         vs[(16 * m + jj) * kD + l], o[jj & 1]);
    }
  }
  if (!in) return;
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  static_cast<float*>(a.out)[(bh * a.tq + i) * kD + l] = (o[0] + o[1]) * inv;
  if (l == 0) a.lse[bh * a.tq + i] = mx + logf(sum);
}

__device__ __forceinline__ void bwd_simt(const Args& a, unsigned char* smem) {
  const Layout L = layout<float>(a.tq, a.tk, true);
  const int64_t bh = blockIdx.x;
  {
    const void* const src[5] = {
        static_cast<const float*>(a.q) + bh * a.tq * kD,
        static_cast<const float*>(a.k) + bh * a.tk * kD,
        static_cast<const float*>(a.v) + bh * a.tk * kD,
        static_cast<const float*>(a.o) + bh * a.tq * kD,
        static_cast<const float*>(a.dout) + bh * a.tq * kD};
    const int dst[5] = {L.q, L.k, L.v, L.o, L.dout};
    const int rows[5] = {a.tq, a.tk, a.tk, a.tq, a.tq};
    start_loads<float>(smem, src, dst, rows);
  }
  const int x = threadIdx.x >> 4, l = threadIdx.x & 15;
  const int rk = round16(a.tk), ld = rk + 1;
  float* ds_s = reinterpret_cast<float*>(smem + L.ds);  // [tq][ld]
  zero_tail<float>(smem + L.q, a.tq);
  zero_tail<float>(smem + L.k, a.tk);
  zero_tail<float>(smem + L.dout, a.tq);
  for (int e = threadIdx.x; e < a.tq * (rk - a.tk); e += blockDim.x)
    ds_s[e / (rk - a.tk) * ld + a.tk + e % (rk - a.tk)] = 0.f;
  const float lse_x = x < a.tq ? a.lse[bh * a.tq + x] : 0.f;
  __syncthreads();
  hopper::mbar_wait(hopper::smem_addr(smem), 0);

  const float* qs = reinterpret_cast<const float*>(smem + L.q);
  const float* ks = reinterpret_cast<const float*>(smem + L.k);
  const float* vs = reinterpret_cast<const float*>(smem + L.v);
  const float* os = reinterpret_cast<const float*>(smem + L.o);
  const float* dos = reinterpret_cast<const float*>(smem + L.dout);
  float* lse_s = reinterpret_cast<float*>(smem + L.lse);
  float* del_s = reinterpret_cast<float*>(smem + L.delta);

  // D of query row x, a half-warp's shuffle sum
  float dd = x < a.tq ? os[x * kD + l] * dos[x * kD + l] : 0.f;
#pragma unroll
  for (int w = 8; w > 0; w >>= 1) dd += __shfl_xor_sync(kFull, dd, w);
  if (x < a.tq && l == 0) {
    del_s[x] = dd;
    lse_s[x] = lse_x;
  }
  __syncthreads();

  // key x: p and dS against queries l + 16 m, then dV and dK of column l
  const bool kin = x < a.tk;
  const float* kr = ks + (kin ? x : 0) * kD;
  const float* vr = vs + (kin ? x : 0) * kD;
  float p[kMaxT / 16], ds[kMaxT / 16];
#pragma unroll
  for (int m = 0; m < kMaxT / 16; ++m) {
    const int i = l + 16 * m;
    p[m] = ds[m] = 0.f;
    if (i < a.tq) {
      // a masked pair skips its dots (whole warps do, causal)
      if (kin && live(a, i, x)) {
        const float s = dot16(kr, qs + i * kD, l);
        const float dp = dot16(vr, dos + i * kD, l);
        p[m] = expf(s * a.scale - lse_s[i]);
        ds[m] = p[m] * (dp - del_s[i]);
      }
      if (kin) ds_s[i * ld + x] = ds[m];
    }
  }
  // a 16-query tile at a time (p and dS 0 past tq, where q and dO are
  // zero), even and odd queries in two sums
  float dk[2] = {0.f, 0.f}, dv[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < kMaxT / 16; ++m) {
    if (16 * m < a.tq) {
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) {
        const int i = 16 * m + ii;
        dv[ii & 1] = fmaf(__shfl_sync(kFull, p[m], ii, 16), dos[i * kD + l],
                          dv[ii & 1]);
        dk[ii & 1] = fmaf(__shfl_sync(kFull, ds[m], ii, 16), qs[i * kD + l],
                          dk[ii & 1]);
      }
    }
  }
  if (kin) {
    static_cast<float*>(a.dk)[(bh * a.tk + x) * kD + l] =
        (dk[0] + dk[1]) * a.scale;
    static_cast<float*>(a.dv)[(bh * a.tk + x) * kD + l] = dv[0] + dv[1];
  }
  __syncthreads();

  // dQ of query row x, column l, from dS (0 past tk, where k is zero), a
  // 16-key tile at a time
  if (x >= a.tq) return;
  float dq[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < kMaxT / 16; ++m) {
    if (16 * m < a.tk) {
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = 16 * m + jj;
        dq[jj & 1] = fmaf(ds_s[x * ld + j], ks[j * kD + l], dq[jj & 1]);
      }
    }
  }
  static_cast<float*>(a.dq)[(bh * a.tq + x) * kD + l] =
      (dq[0] + dq[1]) * a.scale;
}

// ---------------------------------------------------------------------------
// kernels and launches
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(max_threads<T, false>())
    attn_head_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kTc<T>) fwd_tc(a, smem);
  else fwd_simt(a, smem);
}

template <typename T>
__global__ void __launch_bounds__(max_threads<T, true>())
    attn_head_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kTc<T>) bwd_tc(a, smem);
  else bwd_simt(a, smem);
}

// Threads of a block: a warp per 16 queries, and in the backward also a
// warp per 16 keys (bf16); a half-warp for each query, and in the
// backward for each key (float32); in whole warps
template <typename T>
int block_threads(int tq, int tk, bool bwd) {
  if (kTc<T>) return 32 * ((tq + 15) / 16 + (bwd ? (tk + 15) / 16 : 0));
  const int rows = bwd && tk > tq ? tk : tq;
  return 32 * ((rows * 16 + 31) / 32);
}

Args make_args(const void* q, const void* k, const void* v, long long tq,
               long long tk, long long causal, long long q_offset) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.tq = int(tq);
  a.tk = int(tk);
  a.q_offset = q_offset;
  a.causal = causal != 0;
  a.scale = 1.0f / sqrtf(float(kD));
  return a;
}

// 0 when the shapes are the route's (d 16, 1 <= tk <= 64, tq <= 64,
// q_offset >= 0, the block's shared memory within 48 KB), else an error
template <typename T>
int refuse(long long bh, long long tq, long long tk, long long d,
           long long q_offset, bool bwd) {
  if (d != kD || tq < 0 || tq > kMaxT || tk < 1 || tk > kMaxT ||
      q_offset < 0 || bh < 0)
    return int(cudaErrorInvalidValue);
  if (bh > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  if (layout<T>(int(tq), int(tk), bwd).bytes > kSmemLimit)
    return int(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int fwd_entry(const void* q, const void* k, const void* v, void* out,
              void* lse, long long bh, long long tq, long long tk,
              long long d, long long causal, long long q_offset,
              void* stream) {
  if (int err = refuse<T>(bh, tq, tk, d, q_offset, false)) return err;
  if (bh == 0 || tq == 0) return 0;
  Args a = make_args(q, k, v, tq, tk, causal, q_offset);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  attn_head_fwd_kernel<T><<<unsigned(bh), block_threads<T>(a.tq, a.tk, false),
                            layout<T>(a.tq, a.tk, false).bytes,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* dk, void* dv,
              long long bh, long long tq, long long tk, long long d,
              long long causal, long long q_offset, void* stream) {
  if (int err = refuse<T>(bh, tq, tk, d, q_offset, true)) return err;
  if (bh == 0) return 0;
  Args a = make_args(q, k, v, tq, tk, causal, q_offset);
  a.o = o;
  a.dout = dout;
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  attn_head_bwd_kernel<T><<<unsigned(bh), block_threads<T>(a.tq, a.tk, true),
                            layout<T>(a.tq, a.tk, true).bytes,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, out, lse; B*H, tq, tk, d, causal, q_offset; stream
extern "C" int chunked_attention_head_fwd_f32(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long bh, long long tq, long long tk, long long d, long long causal,
    long long q_offset, void* stream) {
  return fwd_entry<float>(q, k, v, out, lse, bh, tq, tk, d, causal, q_offset,
                          stream);
}

extern "C" int chunked_attention_head_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long bh, long long tq, long long tk, long long d, long long causal,
    long long q_offset, void* stream) {
  return fwd_entry<bf16>(q, k, v, out, lse, bh, tq, tk, d, causal, q_offset,
                         stream);
}

// q, k, v, out, dout, lse, dq, dk, dv; B*H, tq, tk, d, causal, q_offset;
// stream
extern "C" int chunked_attention_head_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    long long bh, long long tq, long long tk, long long d, long long causal,
    long long q_offset, void* stream) {
  return bwd_entry<float>(q, k, v, o, dout, lse, dq, dk, dv, bh, tq, tk, d,
                          causal, q_offset, stream);
}

extern "C" int chunked_attention_head_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    long long bh, long long tq, long long tk, long long d, long long causal,
    long long q_offset, void* stream) {
  return bwd_entry<bf16>(q, k, v, o, dout, lse, dq, dk, dv, bh, tq, tk, d,
                         causal, q_offset, stream);
}
