// chunked_attention_sm90: the bf16 chunked-attention forwards redesigned
// for Hopper (sm_90a): a `tile` forward on TMA rings and wgmma, and a
// `split` forward for calls with few queries (decode).  Their backward is
// chunked_attention_bwd_sm90.cu; what the two share (the function, the
// layout of the padded widths) is chunked_attention_sm90.cuh.
//
// Replaces, with chunked_attention.cu, the device loop `jax.lax.scan` in
// `chunked_attention`, src/repro/models/layers.py:110 (no Pallas kernel:
// XLA runs the scan over key chunks of 512 as one loop on the device).
// The forward writes the output and the per-row float32 log-sum-exp
// (natural log), from which any backward route recomputes the
// probabilities.
//
// Routes (the wrapper's attn_plan picks them):
//
// tile forward (d 64, 112, 128, 160): one block a streaming
//   multiprocessor, each walking (b*h, 128-row query tile) items, a head's
//   tiles side by side (they share its K and V in L2), heaviest first.
//   Warpgroup 0's first thread issues TMA loads: an item's Q (while the
//   consumers finish the last item), then its K and V tiles (128 keys at
//   d 64, 64 wider) into rings (3 stages at d 64 and 160, where four would
//   pass 227 KB; 4 at d 112 and 128) with separate full / empty mbarriers
//   for K and for V.  Two consumer warpgroups of 64 rows each (setmaxnreg
//   moves registers to them).  Per key tile a consumer issues S = Q K^T
//   (wgmma, both operands in shared memory) and, in the same turn, O += P
//   V of the previous tile (P from registers, V MN-major), then runs this
//   tile's softmax while the PV product runs: the exponentials of one tile
//   overlap the products of the last.  At d = 64 the two consumers also
//   take turns at issuing (named barriers 1 and 2), so one's softmax runs
//   beside the other's products.
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
// Bounds (chip_smoke.py's _attn_bound): the Whisper encoder forward (128
// heads, 1500^2, d 64) does 73.7 GFLOP (74.5 us at 989 TFLOP/s) and 288 M
// exponentials (68.9 us at 16 a clock an SM): operations and exponentials
// within 8% of each other, hence the overlap.
#include "chunked_attention_sm90.cuh"

namespace {

using namespace attn_sm90;

// ===========================================================================
// tile forward
// ===========================================================================
constexpr int kFwdBQ = 128;  // query rows a block

template <int D>
struct FwdLayout {
  static constexpr int kChunks = chunks_of(D);
  // keys a stage: at d = 128 the output takes 64 registers a thread, and
  // ptxas serialises the products (C7512) unless the scores and P fit
  // beside it in 64 keys (so at every width past 64)
  static constexpr int kBK = D > 64 ? 64 : 128;
  // stages: four at d 160 (Q 48 KB, a K and V stage 48 KB) would take
  // 240 KB of the 227 a block may have
  static constexpr int kStages = D == 64 || kChunks == 3 ? 3 : 4;
  // the consumers take turns at issuing at d = 64, where the exponentials
  // cost as much as the products (at d = 128 the turns cost more than
  // they gave on the H100)
  static constexpr bool kTurns = D == 64;
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
// launches
// ===========================================================================

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

}  // namespace

// q, k, v, out, lse; B*H, tq, tk, d (64, 112, 128 or 160), causal,
// q_offset; stream
extern "C" int chunked_attention_tile_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long bh, long long tq, long long tk, long long d, long long causal,
    long long q_offset, void* stream) {
  if (!shapes_ok(bh, tq, tk, q_offset)) return int(cudaErrorInvalidValue);
  const int off = clamp_offset(tk, q_offset), c = causal != 0;
  float* l = static_cast<float*>(lse);
#define TILE_FWD(D)                                                  \
  if (d == D)                                                        \
    return tile_fwd<D>(q, k, v, out, l, bh, tq, tk, c, off, stream);
  TILE_FWD(64)
  TILE_FWD(112)
  TILE_FWD(128)
  TILE_FWD(160)
#undef TILE_FWD
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
