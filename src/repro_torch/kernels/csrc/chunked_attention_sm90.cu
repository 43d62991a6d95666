// chunked_attention_sm90: the bf16 chunked-attention routes redesigned for
// Hopper (sm_90a): a `tile` forward and backward on TMA rings and wgmma,
// and a `split` forward for calls with few queries (decode).
//
// Replaces, with chunked_attention.cu, the device loop `jax.lax.scan` in
// `chunked_attention`, src/repro/models/layers.py:110 (no Pallas kernel:
// XLA runs the scan over key chunks of 512 as one loop on the device).
// The function is chunked_attention.cu's:
//
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] / sqrt(d)) v[b,h,j]
//
// over the keys j < tk, and j <= q_offset + i when causal (top-left
// alignment, shifted by q_offset).  q, k, v are contiguous bf16 (B*H, T,
// d), 16-byte aligned.  Every row has a live key (tk >= 1, q_offset >= 0).
// The forward writes the output and the per-row float32 log-sum-exp
// (natural log), from which any backward route recomputes the
// probabilities.  Scores, softmax state and sums are float32; p and dS are
// rounded to bf16 for their products (as chunked_attention.cu rounds
// them); exponentials are ex2.approx with scale * log2(e) folded in.
//
// Routes (the wrapper's attn_plan / attn_bwd_plan pick them):
//
// tile forward (d 64, 128): one block a streaming multiprocessor, each
//   walking (b*h, 128-row query tile) items, a head's tiles side by side
//   (they share its K and V in L2), heaviest first.  Warpgroup 0's first
//   thread issues TMA loads: an item's Q (while the consumers finish the
//   last item), then its K and V tiles (128 keys at d 64, 64 at d 128)
//   into rings with
//   separate full / empty mbarriers for K and for V.  Two consumer
//   warpgroups of 64 rows each (setmaxnreg moves registers to them).  Per
//   key tile a consumer issues S = Q K^T (wgmma, both operands in shared
//   memory) and, in the same turn, O += P V of the previous tile (P from
//   registers, V MN-major), then runs this tile's softmax while the PV
//   product runs: the exponentials of one tile overlap the products of
//   the last.  At d = 64 the two consumers also take turns at issuing
//   (named barriers 1 and 2), so one's softmax runs beside the other's
//   products.
//   A TMA box past tk reads zero keys, which score 0 and not -inf, so the
//   last tile masks j >= tk explicitly; under a causal mask tiles past the
//   frontier of the block's last row are never loaded and only tiles that
//   cross a warpgroup's frontier are masked.
//
// split forward (any d of chunked_attention.cu's, Tq up to the plan's
//   threshold): the keys of each (b*h, query row) are cut into splits, a
//   block of four warps each.  A warp reads its
//   keys with 16-byte cp.async copies into a private ring of
//   kSplitStages steps (each lane reads back only what it copied), folds
//   each key into a running (m, l, acc) per row and key group, merges its
//   key groups by shuffles and its warps through shared memory in a fixed
//   order, and writes the float32 partial (m, l, acc[d]) to a workspace.
//   A second kernel combines each row's splits in split order (no
//   atomics; a split with no live key for a row has m = -inf and is
//   skipped) and writes the output and the log-sum-exp.  Bytes bound it:
//   at Whisper's cross decode (128 heads x 1500 keys, d 64) it reads 49
//   MB, 14.7 us at 3.35 TB/s; one block a head (the mma route) cannot
//   draw that from 132 SMs.
//
// tile backward (d 64, 128): chunked_attention.cu's three stages, without
//   atomics.  attn_stats_kernel writes D = rowsum(dO * O) and lse * log2(e)
//   for rows padded to a multiple of 64 (padding rows get lse = +inf, so
//   p = 0).  attn_kv_tile_kernel: a block per (b*h, 128 keys, 64 gradient
//   columns), two consumer warpgroups of 64 keys; Q, dO, lse and D tiles
//   of 64 queries stream through a TMA ring (lse and D by 1-D bulk
//   copies); S^T = K Q^T and dP^T = V dO^T as ss products, P^T =
//   exp2(S^T - lse), dS^T = P^T (dP^T - D), then dV += P^T dO and dK +=
//   dS^T Q as rs products (the accumulator layout of S^T is the A-fragment
//   layout; dO and Q are MN-major B operands).  attn_q_tile_kernel: a block per (b*h, 128
//   query rows); K and V tiles of 64 keys stream through the ring; S = Q
//   K^T and dP = dO V^T as ss products, dS in registers, dQ += dS K as rs
//   with K MN-major.  Every gradient element is summed by one thread in a
//   fixed order, so two runs are bitwise equal.
//
// Bounds (chip_smoke.py's _attn_bound): the Whisper encoder forward (128
// heads, 1500^2, d 64) does 73.7 GFLOP (74.5 us at 989 TFLOP/s) and 288 M
// exponentials (68.9 us at 16 a clock an SM): operations and exponentials
// within 8% of each other, hence the overlap.  Phi-4-mini's training
// backward (192 heads, 256^2 causal, d 128) is bound by its 101 MB.
#include <math_constants.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// O (64 x D) += P (64 x 16, registers) * B (16 x D, smem, MN-major)
template <int D>
__device__ __forceinline__ void rs_product(float (&o)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (D == 64)
    wgmma_rs_m64n64<1>(o, a, b, 1);
  else
    wgmma_rs_m64n128<1>(o, a, b, 1);
}

// S (64 x N) (+)= A (64 x 16, smem) * B (16 x N, smem, K-major)
template <int N>
__device__ __forceinline__ void ss_product(float (&s)[N / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_m64n64<0>(s, a, b, scale_d);
  else
    wgmma_ss_m64n128<0>(s, a, b, scale_d);
}

// Accumulator element i of a thread: its row offset in the 64-row tile
// and its column in the N tile (see hopper.cuh)
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// Two accumulator columns (i, i + 1) of the k-step kk as an A fragment
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4],
                                         const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(c[8 * kk + 2 * j], c[8 * kk + 2 * j + 1]);
}

// Shared memory descriptors of a 128-byte-swizzled tile stored as D/64
// chunks of `chunk` bytes: the K-major operand at k-step kk (16 columns),
// and the MN-major one at k-step kk (16 rows), N = D.
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk,
                                           uint32_t chunk) {
  return sw128_desc(base + (kk / 4) * chunk + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk,
                                            uint32_t chunk) {
  return sw128_desc(base + kk * 2048, chunk, 1024);
}

// ===========================================================================
// tile forward
// ===========================================================================

constexpr int kTileThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kFwdBQ = 128;        // query rows a block

template <int D>
struct FwdLayout {
  // keys a stage: at d = 128 the output takes 64 registers a thread, and
  // ptxas serialises the products (C7512) unless the scores and P fit
  // beside it in 64 keys
  static constexpr int kBK = D == 128 ? 64 : 128;
  static constexpr int kStages = D == 64 ? 3 : 4;
  // the consumers take turns at issuing at d = 64, where the exponentials
  // cost as much as the products (at d = 128 the turns cost more than
  // they gave on the H100)
  static constexpr bool kTurns = D == 64;
  static constexpr int kChunks = D / 64;
  static constexpr int kQChunk = kFwdBQ * 128;
  static constexpr int kKChunk = kBK * 128;
  static constexpr int kQ = kChunks * kQChunk;
  static constexpr int kK = kChunks * kKChunk;  // a K (or V) stage
  static constexpr int kBars = kQ + 2 * kStages * kK;
  // q_full, q_empty, full_k[S], full_v[S], empty_k[S], empty_v[S]
  static constexpr int kSmem = kBars + 8 * (2 + 4 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTileThreads, 1)
attn_tile_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     int tq, int tk, int q_tiles, int items, int causal,
                     int q_offset, float scale_log2) {
  using L = FwdLayout<D>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kQ, sv = sk + S * L::kK;
  const uint32_t q_full = base + L::kBars, q_empty = q_full + 8;
  const uint32_t full_k = q_empty + 8, full_v = full_k + 8 * S;
  const uint32_t empty_k = full_v + 8 * S, empty_v = empty_k + 8 * S;

  // The block walks the items (b*h, query tile) blockIdx.x, + gridDim.x,
  // ...: a head's query tiles side by side (they share its K and V in
  // L2), heaviest first.  The next item's Q and first K and V tiles load
  // while the consumers finish this one.
  auto item_of = [&](int it, int& bh, int& q0, int& n_kt) {
    bh = it / q_tiles;
    q0 = (q_tiles - 1 - it % q_tiles) * kFwdBQ;
    n_kt = (tk + L::kBK - 1) / L::kBK;
    if (causal)  // q_offset >= 0: key 0 is live for every row
      n_kt = min(n_kt, (min(q0 + kFwdBQ, tq) - 1 + q_offset) / L::kBK + 1);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumerWarps);
      mbar_init(empty_v + 8 * s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      int tile = 0;  // K and V tiles loaded so far: the rings' position
      for (int it = blockIdx.x, j = 0; it < items; it += gridDim.x, ++j) {
        int bh, q0, n_kt;
        item_of(it, bh, q0, n_kt);
        mbar_wait(q_empty, (j & 1) ^ 1);
        mbar_expect_tx(q_full, L::kQ);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load_3d(sq + c * L::kQChunk, &qmap, q_full, 64 * c, q0, bh);
        for (int kt = 0; kt < n_kt; ++kt, ++tile) {
          const int s = tile % S;
          const uint32_t ph = ((tile / S) & 1) ^ 1;
          mbar_wait(empty_k + 8 * s, ph);
          mbar_expect_tx(full_k + 8 * s, L::kK);
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_3d(sk + s * L::kK + c * L::kKChunk, &kmap,
                        full_k + 8 * s, 64 * c, kt * L::kBK, bh);
          mbar_wait(empty_v + 8 * s, ph);
          mbar_expect_tx(full_v + 8 * s, L::kK);
#pragma unroll
          for (int c = 0; c < L::kChunks; ++c)
            tma_load_3d(sv + s * L::kK + c * L::kKChunk, &vmap,
                        full_v + 8 * s, 64 * c, kt * L::kBK, bh);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // an item's rows q0 + 64 cw ... + 63
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const uint32_t qa = sq + cw * 64 * 128;
    int first_row = 0, row0 = 0;  // this item's (row0 and row0 + 8)

    float o[D / 2];
    float m[2], l[2];
    float sc[L::kBK / 2];
    uint32_t pa[L::kBK / 16][4];

    // one tile's online softmax on sc, in place, in the log2 domain: the
    // keys past tk and past the causal frontier masked, m updated, and
    // each row's rescale of the old sums and this tile's sum returned (a
    // row with nothing live yet keeps m = -inf, l = 0, o = 0)
    auto softmax = [&](int kt, float (&alpha)[2], float (&sum)[2]) {
      const int k0 = kt * L::kBK;
      if (k0 + L::kBK > tk ||
          (causal && k0 + L::kBK - 1 > first_row + q_offset)) {
#pragma unroll
        for (int i = 0; i < L::kBK / 2; ++i) {
          const int row = row0 + acc_row(i), col = k0 + acc_col(i, lane);
          if (col >= tk || (causal && col > row + q_offset))
            sc[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, mu[2];
#pragma unroll
      for (int i = 0; i < L::kBK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -CUDART_INF_F ? 0.0f : m_new;
        alpha[r] = ex2(m[r] - mu[r]);
        m[r] = m_new;
        sum[r] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < L::kBK / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -mu[r]));
        sum[r] += sc[i];
      }
    };

    // the first consumer takes the first turn at issuing
    if (L::kTurns && cw == 1) bar_arrive(1, 256);
    int tile = 0;  // K and V tiles consumed so far
    for (int it = blockIdx.x, j = 0; it < items; it += gridDim.x, ++j) {
      int bh, q0, n_kt;
      item_of(it, bh, q0, n_kt);
      first_row = q0 + 64 * cw;
      row0 = first_row + 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = -CUDART_INF_F;
        l[r] = 0.0f;
      }

      // The first tile: Q K^T alone.  No product is issued under a
      // condition: ptxas serialises every wgmma of a kernel that does.
      mbar_wait(q_full, j & 1);
      {
        const int s = tile % S;
        mbar_wait(full_k + 8 * s, (tile / S) & 1);
        const uint32_t ks = sk + s * L::kK;
        if (L::kTurns) bar_sync(1 + cw, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ss_product<L::kBK>(sc, kmajor(qa, kk, L::kQChunk),
                             kmajor(ks, kk, L::kKChunk), kk > 0);
        wgmma_commit();
        if (L::kTurns) bar_arrive(2 - cw, 256);  // the other's turn
        wgmma_wait<0>();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty_k + 8 * s);
          if (n_kt == 1) mbar_arrive(q_empty);
        }
        float alpha[2], sum[2];
        softmax(0, alpha, sum);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = sum[r];
        to_frags<L::kBK>(pa, sc);
      }
      for (int kt = 1; kt < n_kt; ++kt) {
        const int s = (tile + kt) % S, sp = (tile + kt - 1) % S;
        mbar_wait(full_k + 8 * s, ((tile + kt) / S) & 1);
        mbar_wait(full_v + 8 * sp, ((tile + kt - 1) / S) & 1);
        const uint32_t ks = sk + s * L::kK, vs = sv + sp * L::kK;

        if (L::kTurns) bar_sync(1 + cw, 256);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ss_product<L::kBK>(sc, kmajor(qa, kk, L::kQChunk),
                             kmajor(ks, kk, L::kKChunk), kk > 0);
        wgmma_commit();
        // O += P V of the previous tile, beside this tile's softmax
#pragma unroll
        for (int kk = 0; kk < L::kBK / 16; ++kk)
          rs_product<D>(o, pa[kk], mnmajor(vs, kk, L::kKChunk));
        wgmma_commit();
        if (L::kTurns) bar_arrive(2 - cw, 256);
        wgmma_wait<1>();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(empty_k + 8 * s);
          if (kt + 1 == n_kt) mbar_arrive(q_empty);  // Q's last product
        }

        float alpha[2], sum[2];
        softmax(kt, alpha, sum);
        wgmma_wait<0>();
        fence_regs(o);
        fence_frags(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_v + 8 * sp);
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
        to_frags<L::kBK>(pa, sc);
      }
      {
        // the last tile's PV
        const int sl = (tile + n_kt - 1) % S;
        mbar_wait(full_v + 8 * sl, ((tile + n_kt - 1) / S) & 1);
        const uint32_t vs = sv + sl * L::kK;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::kBK / 16; ++kk)
          rs_product<D>(o, pa[kk], mnmajor(vs, kk, L::kKChunk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_frags(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_v + 8 * sl);
      }
      tile += n_kt;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.0f / l[r];
      }
      bf16* og = out + int64_t(bh) * tq * D;
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int r = (i / 2) % 2, row = row0 + 8 * r;
        if (row < tq)
          *reinterpret_cast<uint32_t*>(og + int64_t(row) * D +
                                       acc_col(i, lane)) =
              pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < tq)
            lse[int64_t(bh) * tq + row] = (m[r] + log2f(l[r])) * kLn2;
        }
      }
    }
    // the second consumer's last arrival
    if (L::kTurns && cw == 0) bar_sync(1, 256);
  }
}

// ===========================================================================
// split forward
// ===========================================================================

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitStages = 8;  // key steps in flight a warp, at most

template <int D>
struct SplitShape {
  static constexpr int kVec = D / 8;  // 16-byte vectors a row
  // lanes a key and vectors a lane
  static constexpr int kL = kVec <= 2 ? 2 : kVec <= 8 ? 8 : 16;
  static constexpr int kV = (kVec + kL - 1) / kL;
  static constexpr int kKeys = 32 / kL;  // keys a warp step
  static constexpr int kStep = kKeys * D;  // bf16 of K (or V) a step
  // key steps in flight a warp (the ring stays under 48 KB of static
  // shared memory at d = 160)
  static constexpr int kStages = kStep * 4 <= 1024 ? kSplitStages : 6;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bf16x8(float (&f)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Merge the running state (m2, l2, acc2) into (m, l, acc), log2 domain;
// a state with m = -inf holds nothing
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[N],
                                      float m2, float l2,
                                      const float (&acc2)[N]) {
  const float mt = fmaxf(m, m2);
  const float mu = mt == -CUDART_INF_F ? 0.0f : mt;
  const float a = ex2(m - mu), b = ex2(m2 - mu);
  l = l * a + l2 * b;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * a + acc2[i] * b;
  m = mt;
}

// A block per (b*h, query row, split).  Workspace of a call: acc[rows]
// [splits][D], then (m, l)[rows][splits], rows = B*H*tq.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
attn_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, float* __restrict__ ws,
                  int64_t rows, int tq, int tk, int n_splits, int split_keys,
                  int causal, int q_offset, float scale_log2) {
  using P = SplitShape<D>;
  constexpr int kAcc = P::kV * 8;
  __shared__ __align__(16) bf16 ring[kSplitWarps][P::kStages][2][P::kStep];
  __shared__ float red_ml[kSplitWarps][2];
  __shared__ float red_acc[kSplitWarps][D];

  const int sp = int(blockIdx.x % unsigned(n_splits));
  const int64_t row = blockIdx.x / unsigned(n_splits);  // b*h*tq + i
  const int64_t bh = row / tq;
  const int i = int(row % tq);
  const int k_lo = sp * split_keys;
  int k_hi = min(tk, k_lo + split_keys);
  if (causal) k_hi = min(k_hi, q_offset + i + 1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / P::kL, c0 = lane % P::kL;
  const bf16* kg = k + bh * tk * D;
  const bf16* vg = v + bh * tk * D;

  float qv[kAcc], acc[kAcc];
#pragma unroll
  for (int u = 0; u < P::kV; ++u) {
    const int c = c0 + P::kL * u;
    float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (c < P::kVec)
      bf16x8(f, *reinterpret_cast<const uint4*>(q + row * D + 8 * c));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qv[8 * u + e] = f[e];
      acc[8 * u + e] = 0.0f;
    }
  }
  float m = -CUDART_INF_F, l = 0.0f;

  const int n_steps = k_lo < k_hi ? (k_hi - k_lo + P::kKeys - 1) / P::kKeys
                                  : 0;
  // this warp's steps: warp, warp + 4, ...; a step's key for lane group g
  auto issue = [&](int n) {
    const int st = warp + kSplitWarps * n;
    if (st < n_steps) {
      const int j = k_lo + st * P::kKeys + g;
      const bool live = j < k_hi;
      const int stage = n % P::kStages;
#pragma unroll
      for (int u = 0; u < P::kV; ++u) {
        const int c = c0 + P::kL * u;
        if (c < P::kVec) {
          const int64_t at = int64_t(live ? j : 0) * D + 8 * c;
          cp_async16(smem_addr(&ring[warp][stage][0][g * D + 8 * c]),
                     kg + at, live);
          cp_async16(smem_addr(&ring[warp][stage][1][g * D + 8 * c]),
                     vg + at, live);
        }
      }
    }
    cp_async_commit();
  };
  const int my_steps = n_steps > warp
                           ? (n_steps - warp + kSplitWarps - 1) / kSplitWarps
                           : 0;
#pragma unroll
  for (int n = 0; n < P::kStages - 1; ++n) issue(n);
  for (int n = 0; n < my_steps; ++n) {
    issue(n + P::kStages - 1);
    cp_async_wait<P::kStages - 1>();
    const int stage = n % P::kStages;
    const int j = k_lo + (warp + kSplitWarps * n) * P::kKeys + g;
    float kf[kAcc], vf[kAcc];
#pragma unroll
    for (int u = 0; u < P::kV; ++u) {
      const int c = c0 + P::kL * u;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (c < P::kVec) {
        kw = *reinterpret_cast<const uint4*>(
            &ring[warp][stage][0][g * D + 8 * c]);
        vw = *reinterpret_cast<const uint4*>(
            &ring[warp][stage][1][g * D + 8 * c]);
      }
      float f[8];
      bf16x8(f, kw);
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[8 * u + e] = f[e];
      bf16x8(f, vw);
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[8 * u + e] = f[e];
    }
    float dot = 0.0f;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) dot = fmaf(qv[e], kf[e], dot);
#pragma unroll
    for (int w = P::kL / 2; w > 0; w >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, w);
    // keys from k_hi on are past tk or past the row's causal frontier
    const float s = j < k_hi ? dot * scale_log2 : -CUDART_INF_F;
    const float mt = fmaxf(m, s);
    const float mu = mt == -CUDART_INF_F ? 0.0f : mt;
    const float a = ex2(m - mu), p = ex2(s - mu);
    l = l * a + p;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[e] = fmaf(p, vf[e], acc[e] * a);
    m = mt;
    __syncwarp();  // this step's reads are done before its stage refills
  }
  cp_async_wait<0>();

  // merge the warp's key groups (a butterfly: every lane ends with the
  // warp's state for its columns)
#pragma unroll
  for (int w = P::kL; w < 32; w <<= 1) {
    float acc2[kAcc];
#pragma unroll
    for (int e = 0; e < kAcc; ++e)
      acc2[e] = __shfl_xor_sync(0xffffffffu, acc[e], w);
    merge<kAcc>(m, l, acc, __shfl_xor_sync(0xffffffffu, m, w),
                __shfl_xor_sync(0xffffffffu, l, w), acc2);
  }
  // then the warps, in order, through shared memory
  if (g == 0) {
    if (c0 == 0) {
      red_ml[warp][0] = m;
      red_ml[warp][1] = l;
    }
#pragma unroll
    for (int u = 0; u < P::kV; ++u) {
      const int c = c0 + P::kL * u;
      if (c < P::kVec)
#pragma unroll
        for (int e = 0; e < 8; ++e) red_acc[warp][8 * c + e] = acc[8 * u + e];
    }
  }
  __syncthreads();
  if (warp != 0 || g != 0) return;
  for (int w = 1; w < kSplitWarps; ++w) {
    float a2[kAcc];
#pragma unroll
    for (int u = 0; u < P::kV; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + P::kL * u;
        a2[8 * u + e] = c < P::kVec ? red_acc[w][8 * c + e] : 0.0f;
      }
    merge<kAcc>(m, l, acc, red_ml[w][0], red_ml[w][1], a2);
  }
  float* wa = ws + (row * n_splits + sp) * D;
#pragma unroll
  for (int u = 0; u < P::kV; ++u) {
    const int c = c0 + P::kL * u;
    if (c < P::kVec) {
      reinterpret_cast<float4*>(wa + 8 * c)[0] =
          make_float4(acc[8 * u], acc[8 * u + 1], acc[8 * u + 2],
                      acc[8 * u + 3]);
      reinterpret_cast<float4*>(wa + 8 * c)[1] =
          make_float4(acc[8 * u + 4], acc[8 * u + 5], acc[8 * u + 6],
                      acc[8 * u + 7]);
    }
  }
  if (c0 == 0) {
    float* wm = ws + rows * n_splits * D + (row * n_splits + sp) * 2;
    wm[0] = m;
    wm[1] = l;
  }
}

// Each row's splits in split order: out = sum a_s acc_s / sum a_s l_s,
// a_s = exp2(m_s - max m); a warp a row
template <int D>
__global__ void __launch_bounds__(128)
attn_combine_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                    float* __restrict__ lse, int64_t rows, int n_splits) {
  constexpr int kC = (D + 31) / 32;
  const int64_t row = int64_t(blockIdx.x) * 4 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const float* wa = ws + row * n_splits * D;
  const float* wm = ws + rows * n_splits * D + row * n_splits * 2;
  float mt = -CUDART_INF_F;
  for (int s = 0; s < n_splits; ++s) mt = fmaxf(mt, wm[2 * s]);
  float lt = 0.0f, acc[kC];
#pragma unroll
  for (int u = 0; u < kC; ++u) acc[u] = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const float ms = wm[2 * s];
    if (ms == -CUDART_INF_F) continue;  // no live key for this row
    const float a = ex2(ms - mt);
    lt = fmaf(wm[2 * s + 1], a, lt);
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      const int c = lane + 32 * u;
      if (c < D) acc[u] = fmaf(wa[s * D + c], a, acc[u]);
    }
  }
  const float inv = 1.0f / lt;
#pragma unroll
  for (int u = 0; u < kC; ++u) {
    const int c = lane + 32 * u;
    if (c < D) out[row * D + c] = __float2bfloat16_rn(acc[u] * inv);
  }
  if (lane == 0) lse[row] = (mt + log2f(lt)) * kLn2;
}

// ===========================================================================
// tile backward
// ===========================================================================

constexpr int kStatRows = 64;  // the padding of the row statistics

// lse2 = lse * log2(e) and D = rowsum(dO * O) for rows padded to a
// multiple of kStatRows (padding: lse2 = +inf, D = 0); a warp a row
template <int D>
__global__ void __launch_bounds__(256)
attn_stats_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ lse2,
                  float* __restrict__ delta, int64_t bh_count, int tq,
                  int tq_pad) {
  const int64_t at = int64_t(blockIdx.x) * 8 + threadIdx.x / 32;
  if (at >= bh_count * tq_pad) return;
  const int64_t bh = at / tq_pad;
  const int i = int(at % tq_pad), lane = threadIdx.x % 32;
  if (i >= tq) {
    if (lane == 0) {
      lse2[at] = CUDART_INF_F;
      delta[at] = 0.0f;
    }
    return;
  }
  const int64_t row = bh * tq + i;
  float acc = 0.0f;
  for (int c = lane; c < D / 8; c += 32) {
    float a[8], b[8];
    bf16x8(a, reinterpret_cast<const uint4*>(o + row * D)[c]);
    bf16x8(b, reinterpret_cast<const uint4*>(dout + row * D)[c]);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], b[e], acc);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    lse2[at] = lse[row] * kLog2e;
    delta[at] = acc;
  }
}

// ---------------------------------------------------------------- dK, dV

constexpr int kKvBK = 128;  // keys a block (two warpgroups of 64)

template <int D>
struct KvLayout {
  // gradient columns a block owns: at d = 128 the dK and dV accumulators
  // of all columns (128 registers a thread) leave ptxas too few registers
  // to pipeline the products (C7512), so two blocks take 64 columns each
  // (both recompute S^T and dP^T)
  static constexpr int kCols = 64;
  static constexpr int kQN = 64;  // queries a stage
  static constexpr int kStages = 2;
  static constexpr int kChunks = D / 64;
  static constexpr int kKChunk = kKvBK * 128;
  static constexpr int kK = kChunks * kKChunk;  // the K (and the V) tile
  static constexpr int kQChunk = kQN * 128;
  static constexpr int kQ = kChunks * kQChunk;  // a Q (or dO) tile
  static constexpr int kStat = kQN * 4;         // lse2 (or D) of a tile
  static constexpr int kStage = 2 * kQ + 1024;  // Q, dO, lse2, D (padded)
  static constexpr int kBars = 2 * kK + kStages * kStage;
  // kv, full[S], empty[S]
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTileThreads, 1)
attn_kv_tile_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int kv_tiles, int tq, int tq_pad,
                    int tk, int causal, int q_offset, float scale,
                    float scale_log2) {
  using L = KvLayout<D>;
  constexpr int S = L::kStages, QN = L::kQN, C = L::kCols;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + L::kK, st0 = base + 2 * L::kK;
  const uint32_t kvbar = base + L::kBars;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * S;
  const uint8_t* gen = smem + (base - smem_addr(smem));

  // a head's key tiles side by side (they share its Q and dO in L2)
  const int block = int(blockIdx.x) / (D / C);
  const int part = int(blockIdx.x) % (D / C);
  const int bh = block / kv_tiles;
  const int k0 = block % kv_tiles * kKvBK;
  // causal: query i sees key k0 first when i + q_offset >= k0
  const int i_first =
      causal && k0 > q_offset ? (k0 - q_offset) / QN * QN : 0;
  const int n_qt = i_first < tq ? (tq - i_first + QN - 1) / QN : 0;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && n_qt > 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&domap);
      mbar_expect_tx(kvbar, 2 * L::kK);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load_3d(sk + c * L::kKChunk, &kmap, kvbar, 64 * c, k0, bh);
        tma_load_3d(sv + c * L::kKChunk, &vmap, kvbar, 64 * c, k0, bh);
      }
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % S, qi = i_first + it * QN;
        const uint32_t full = full0 + 8 * s, st = st0 + s * L::kStage;
        mbar_wait(empty0 + 8 * s, ((it / S) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kQ + 2 * L::kStat);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_3d(st + c * L::kQChunk, &qmap, full, 64 * c, qi, bh);
          tma_load_3d(st + L::kQ + c * L::kQChunk, &domap, full, 64 * c, qi,
                      bh);
        }
        const int64_t at = int64_t(bh) * tq_pad + qi;
        bulk_load(st + 2 * L::kQ, lse2 + at, L::kStat, full);
        bulk_load(st + 2 * L::kQ + L::kStat, delta + at, L::kStat, full);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // keys k0 + 64 cw ... + 63
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int first_key = k0 + 64 * cw;
    const int key0 = first_key + 16 * warp + lane / 4;  // and key0 + 8
    const uint32_t ka = sk + cw * 64 * 128, va = sv + cw * 64 * 128;

    // this block's gradient columns part * C ... + C - 1: chunk `part`
    // of the 128-byte-swizzled Q and dO tiles
    float dkr[C / 2], dvr[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) dkr[i] = dvr[i] = 0.0f;
    if (n_qt > 0) mbar_wait(kvbar, 0);
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % S, qi = i_first + it * QN;
      const uint32_t st = st0 + s * L::kStage;
      const float* ls = reinterpret_cast<const float*>(
          gen + (st - base) + 2 * L::kQ);
      const float* ds = ls + QN;
      mbar_wait(full0 + 8 * s, (it / S) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float stt[QN / 2], dpt[QN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_product<QN>(stt, kmajor(ka, kk, L::kKChunk),
                           kmajor(st, kk, L::kQChunk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_product<QN>(dpt, kmajor(va, kk, L::kKChunk),
                           kmajor(st + L::kQ, kk, L::kQChunk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(stt);
      const bool edge = causal && first_key + 63 > q_offset + qi;
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) {
        const int col = acc_col(i, lane);
        float p = ex2(fmaf(stt[i], scale_log2, -ls[col]));
        if (edge && key0 + acc_row(i) > q_offset + qi + col) p = 0.0f;
        stt[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < QN / 2; ++i)
        dpt[i] = stt[i] * (dpt[i] - ds[acc_col(i, lane)]);
      uint32_t pa[QN / 16][4], da[QN / 16][4];
      to_frags<QN>(pa, stt);
      to_frags<QN>(da, dpt);

      // dV += P^T dO, dK += dS^T Q (dO and Q MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        rs_product<C>(dvr, pa[kk], mnmajor(st + L::kQ + part * L::kQChunk,
                                           kk, L::kQChunk));
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        rs_product<C>(dkr, da[kk], mnmajor(st + part * L::kQChunk, kk,
                                           L::kQChunk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dvr);
      fence_regs(dkr);
      fence_frags(pa);
      fence_frags(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    bf16* dkg = dk + int64_t(bh) * tk * D;
    bf16* dvg = dv + int64_t(bh) * tk * D;
#pragma unroll
    for (int i = 0; i < C / 2; i += 2) {
      const int key = key0 + acc_row(i);
      if (key < tk) {
        const int64_t at = int64_t(key) * D + part * C + acc_col(i, lane);
        *reinterpret_cast<uint32_t*>(dkg + at) =
            pack_bf16(dkr[i] * scale, dkr[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvg + at) =
            pack_bf16(dvr[i], dvr[i + 1]);
      }
    }
  }
}

// -------------------------------------------------------------------- dQ

constexpr int kQBQ = 128;  // query rows a block (two warpgroups of 64)
constexpr int kQBK = 64;   // keys a stage

template <int D>
struct QLayout {
  static constexpr int kStages = 2;
  static constexpr int kChunks = D / 64;
  static constexpr int kQChunk = kQBQ * 128;
  static constexpr int kQ = kChunks * kQChunk;  // the Q (and the dO) tile
  static constexpr int kKChunk = kQBK * 128;
  static constexpr int kK = kChunks * kKChunk;  // a K (or V) tile
  static constexpr int kStage = 2 * kK;
  static constexpr int kBars = 2 * kQ + kStages * kStage;
  // q, full[S], empty[S]
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTileThreads, 1)
attn_q_tile_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int tq, int tq_pad, int tk, int q_tiles, int causal,
                   int q_offset, float scale, float scale_log2) {
  using L = QLayout<D>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + L::kQ, st0 = base + 2 * L::kQ;
  const uint32_t qbar = base + L::kBars;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * S;

  const int bh = int(blockIdx.x) / q_tiles;
  const int qt = q_tiles - 1 - int(blockIdx.x) % q_tiles;
  const int q0 = qt * kQBQ;
  int n_kt = (tk + kQBK - 1) / kQBK;
  if (causal)
    n_kt = min(n_kt, (min(q0 + kQBQ, tq) - 1 + q_offset) / kQBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      prefetch_map(&domap);
      mbar_expect_tx(qbar, 2 * L::kQ);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load_3d(sq + c * L::kQChunk, &qmap, qbar, 64 * c, q0, bh);
        tma_load_3d(sdo + c * L::kQChunk, &domap, qbar, 64 * c, q0, bh);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S;
        const uint32_t full = full0 + 8 * s, st = st0 + s * L::kStage;
        mbar_wait(empty0 + 8 * s, ((kt / S) & 1) ^ 1);
        mbar_expect_tx(full, L::kStage);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_3d(st + c * L::kKChunk, &kmap, full, 64 * c, kt * kQBK,
                      bh);
          tma_load_3d(st + L::kK + c * L::kKChunk, &vmap, full, 64 * c,
                      kt * kQBK, bh);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int first_row = q0 + 64 * cw;
    const int row0 = first_row + 16 * warp + lane / 4;  // and row0 + 8
    const uint32_t qa = sq + cw * 64 * 128, doa = sdo + cw * 64 * 128;
    float lsr[2], dlr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t at = int64_t(bh) * tq_pad + row0 + 8 * r;
      const bool in = row0 + 8 * r < tq_pad;
      lsr[r] = in ? lse2[at] : CUDART_INF_F;
      dlr[r] = in ? delta[at] : 0.0f;
    }
    float dqr[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqr[i] = 0.0f;

    mbar_wait(qbar, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % S;
      const uint32_t ks = st0 + s * L::kStage, vs = ks + L::kK;
      mbar_wait(full0 + 8 * s, (kt / S) & 1);

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
      float sc[kQBK / 2], dp[kQBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64<0>(sc, kmajor(qa, kk, L::kQChunk),
                           kmajor(ks, kk, L::kKChunk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64<0>(dp, kmajor(doa, kk, L::kQChunk),
                           kmajor(vs, kk, L::kKChunk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      const int k0 = kt * kQBK;
      const bool edge =
          k0 + kQBK > tk || (causal && k0 + kQBK - 1 > first_row + q_offset);
#pragma unroll
      for (int i = 0; i < kQBK / 2; ++i) {
        const int r = (i / 2) % 2;
        float p = ex2(fmaf(sc[i], scale_log2, -lsr[r]));
        if (edge) {
          const int col = k0 + acc_col(i, lane), row = row0 + 8 * r;
          if (col >= tk || (causal && col > row + q_offset)) p = 0.0f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kQBK / 2; ++i)
        dp[i] = sc[i] * (dp[i] - dlr[(i / 2) % 2]);
      uint32_t da[kQBK / 16][4];
      to_frags<kQBK>(da, dp);

      // dQ += dS K (K MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQBK / 16; ++kk)
        rs_product<D>(dqr, da[kk], mnmajor(ks, kk, L::kKChunk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqr);
      fence_frags(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    bf16* dqg = dq + int64_t(bh) * tq * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = row0 + acc_row(i);
      if (row < tq)
        *reinterpret_cast<uint32_t*>(dqg + int64_t(row) * D +
                                     acc_col(i, lane)) =
            pack_bf16(dqr[i] * scale, dqr[i + 1] * scale);
    }
  }
}

// ===========================================================================
// launches
// ===========================================================================

bool shapes_ok(int64_t bh, int64_t tq, int64_t tk, int64_t q_offset) {
  return bh >= 1 && tq >= 1 && tk >= 1 && q_offset >= 0 &&
         tq <= 0x7fffff00LL && tk <= 0x7fffff00LL && bh <= 0x7fffffffLL;
}

template <int D>
int tile_fwd(const void* q, const void* k, const void* v, void* out,
             float* lse, int64_t bh, int64_t tq, int64_t tk, int causal,
             int q_offset, void* stream) {
  using L = FwdLayout<D>;
  static bool opted[64] = {};
  int err = smem_opt_in(attn_tile_fwd_kernel<D>, L::kSmem, opted);
  if (err) return err;
  const int64_t q_tiles = (tq + kFwdBQ - 1) / kFwdBQ;
  if (bh * q_tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  // one block a streaming multiprocessor, each walking its items
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int64_t items = bh * q_tiles;
  const int64_t blocks = items < sms ? items : sms;
  CUtensorMap qm, km, vm;
  if ((err = map_3d(&qm, q, D, tq, bh, 64, kFwdBQ))) return err;
  if ((err = map_3d(&km, k, D, tk, bh, 64, L::kBK))) return err;
  if ((err = map_3d(&vm, v, D, tk, bh, 64, L::kBK))) return err;
  attn_tile_fwd_kernel<D><<<unsigned(blocks), kTileThreads, L::kSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<bf16*>(out), lse, int(tq), int(tk),
      int(q_tiles), int(items), causal, q_offset, kLog2e / sqrtf(float(D)));
  return int(cudaGetLastError());
}

template <int D>
int split_fwd(const void* q, const void* k, const void* v, void* out,
              float* lse, float* ws, int64_t bh, int64_t tq, int64_t tk,
              int causal, int q_offset, int64_t n_splits, int64_t split_keys,
              void* stream) {
  if (n_splits < 1 || split_keys < 1 || (n_splits - 1) * split_keys >= tk ||
      n_splits * split_keys < tk)
    return int(cudaErrorInvalidValue);
  const int64_t blocks = bh * tq * n_splits;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attn_split_kernel<D><<<unsigned(blocks), kSplitThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), ws, bh * tq, int(tq), int(tk),
      int(n_splits), int(split_keys), causal, q_offset,
      kLog2e / sqrtf(float(D)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  attn_combine_kernel<D><<<unsigned((bh * tq + 3) / 4), 128, 0, s>>>(
      ws, static_cast<bf16*>(out), lse, bh * tq, int(n_splits));
  return int(cudaGetLastError());
}

template <int D>
int tile_bwd(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* stats, void* dq,
             void* dk, void* dv, int64_t bh, int64_t tq, int64_t tk,
             int causal, int q_offset, void* stream) {
  static bool opted_kv[64] = {}, opted_q[64] = {};
  int err = smem_opt_in(attn_kv_tile_kernel<D>, KvLayout<D>::kSmem, opted_kv);
  if (err) return err;
  if ((err = smem_opt_in(attn_q_tile_kernel<D>, QLayout<D>::kSmem, opted_q)))
    return err;
  const int64_t tq_pad = (tq + kStatRows - 1) / kStatRows * kStatRows;
  const int64_t kv_tiles = (tk + kKvBK - 1) / kKvBK;
  const int64_t kv_parts = D / KvLayout<D>::kCols;
  const int64_t q_tiles = (tq + kQBQ - 1) / kQBQ;
  if (bh * kv_tiles * kv_parts > 0x7fffffffLL ||
      bh * q_tiles > 0x7fffffffLL ||
      bh * tq_pad / 8 + 1 > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  float* lse2 = stats;
  float* delta = stats + bh * tq_pad;
  CUtensorMap qkv, kkv, vkv, dokv, qq, kq, vq, doq;
  if ((err = map_3d(&qkv, q, D, tq, bh, 64, KvLayout<D>::kQN))) return err;
  if ((err = map_3d(&dokv, dout, D, tq, bh, 64, KvLayout<D>::kQN)))
    return err;
  if ((err = map_3d(&kkv, k, D, tk, bh, 64, kKvBK))) return err;
  if ((err = map_3d(&vkv, v, D, tk, bh, 64, kKvBK))) return err;
  if ((err = map_3d(&qq, q, D, tq, bh, 64, kQBQ))) return err;
  if ((err = map_3d(&doq, dout, D, tq, bh, 64, kQBQ))) return err;
  if ((err = map_3d(&kq, k, D, tk, bh, 64, kQBK))) return err;
  if ((err = map_3d(&vq, v, D, tk, bh, 64, kQBK))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(float(D)), scale_log2 = kLog2e * scale;
  attn_stats_kernel<D><<<unsigned((bh * tq_pad + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse2,
      delta, bh, int(tq), int(tq_pad));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  attn_kv_tile_kernel<D><<<unsigned(bh * kv_tiles * kv_parts), kTileThreads,
                           KvLayout<D>::kSmem, s>>>(
      qkv, kkv, vkv, dokv, lse2, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), int(kv_tiles), int(tq), int(tq_pad), int(tk),
      causal,
      q_offset, scale, scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  attn_q_tile_kernel<D><<<unsigned(bh * q_tiles), kTileThreads,
                          QLayout<D>::kSmem, s>>>(
      qq, kq, vq, doq, lse2, delta, static_cast<bf16*>(dq), int(tq),
      int(tq_pad), int(tk), int(q_tiles), causal, q_offset, scale,
      scale_log2);
  return int(cudaGetLastError());
}

// q_offset as the kernels take it: past tk - 1 every key is live, so
// larger offsets clamp there (and fit an int)
int clamp_offset(int64_t tk, int64_t q_offset) {
  return int(q_offset < tk ? q_offset : tk);
}

}  // namespace

// q, k, v, out, lse; B*H, tq, tk, d (64 or 128), causal, q_offset; stream
extern "C" int chunked_attention_tile_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long bh, long long tq, long long tk, long long d, long long causal,
    long long q_offset, void* stream) {
  if (!shapes_ok(bh, tq, tk, q_offset)) return int(cudaErrorInvalidValue);
  const int off = clamp_offset(tk, q_offset), c = causal != 0;
  float* l = static_cast<float*>(lse);
  if (d == 64) return tile_fwd<64>(q, k, v, out, l, bh, tq, tk, c, off, stream);
  if (d == 128)
    return tile_fwd<128>(q, k, v, out, l, bh, tq, tk, c, off, stream);
  return int(cudaErrorInvalidValue);
}

// q, k, v, out, lse, ws (float32 workspace, B*H*tq*n_splits*(d + 2));
// B*H, tq, tk, d (16, 64, 112, 128 or 160), causal, q_offset, n_splits,
// split_keys (n_splits * split_keys >= tk, every split non-empty); stream
extern "C" int chunked_attention_split_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* ws, long long bh, long long tq, long long tk, long long d,
    long long causal, long long q_offset, long long n_splits,
    long long split_keys, void* stream) {
  if (!shapes_ok(bh, tq, tk, q_offset)) return int(cudaErrorInvalidValue);
  const int off = clamp_offset(tk, q_offset), c = causal != 0;
  float* l = static_cast<float*>(lse);
  float* w = static_cast<float*>(ws);
#define SPLIT(D)                                                           \
  if (d == D)                                                              \
    return split_fwd<D>(q, k, v, out, l, w, bh, tq, tk, c, off, n_splits, \
                        split_keys, stream);
  SPLIT(16)
  SPLIT(64)
  SPLIT(112)
  SPLIT(128)
  SPLIT(160)
#undef SPLIT
  return int(cudaErrorInvalidValue);
}

// q, k, v, out, dout, lse, stats (float32 workspace, 2*B*H*tq_pad with
// tq_pad = tq rounded up to 64), dq, dk, dv; B*H, tq, tk, d (64 or 128),
// causal, q_offset; stream
extern "C" int chunked_attention_tile_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* stats, void* dq, void* dk,
    void* dv, long long bh, long long tq, long long tk, long long d,
    long long causal, long long q_offset, void* stream) {
  if (!shapes_ok(bh, tq, tk, q_offset)) return int(cudaErrorInvalidValue);
  const int off = clamp_offset(tk, q_offset), c = causal != 0;
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  if (d == 64)
    return tile_bwd<64>(q, k, v, o, dout, l, st, dq, dk, dv, bh, tq, tk, c,
                        off, stream);
  if (d == 128)
    return tile_bwd<128>(q, k, v, o, dout, l, st, dq, dk, dv, bh, tq, tk, c,
                         off, stream);
  return int(cudaErrorInvalidValue);
}
