// chunked_attention_bwd_sm90: the bf16 chunked-attention backward
// redesigned for Hopper (sm_90a), the `tile` route on TMA rings and wgmma,
// from any forward route's output and log-sum-exp.  What it shares with
// the forwards of chunked_attention_sm90.cu (the function, the layout of
// the padded widths) is chunked_attention_sm90.cuh.
//
// Replaces, with chunked_attention.cu's backward, the gradient of the
// device loop `jax.lax.scan` in `chunked_attention`,
// src/repro/models/layers.py:110 (XLA differentiates the scan).
//
// tile backward (d 64, 112, 128, 160; the wrapper's attn_bwd_plan picks
//   it): chunked_attention.cu's three stages, without atomics.
//   attn_stats_kernel writes D = rowsum(dO * O) and lse * log2(e) for rows
//   padded to a multiple of 64 (padding rows get lse = +inf, so p = 0).
//   attn_kv_tile_kernel: a block per (b*h, 128 keys, its share of the
//   gradients), two consumer warpgroups of 64 keys; Q, dO, lse and D tiles
//   of 64 queries (32 in the dK launch at d 160) stream through a TMA ring
//   (lse and D by 1-D bulk copies); S^T = K Q^T and dP^T = V dO^T as ss
//   products, P^T = exp2(S^T - lse), dS^T = P^T (dP^T - D), then dV +=
//   P^T dO and dK += dS^T Q as rs products (the accumulator layout of S^T
//   is the A-fragment layout; dO and Q are MN-major B operands).  A key
//   tile's gradients are split between blocks (KvPlan): by 64-column
//   chunks (each block recomputes S^T and dP^T) at d 64, 112 and 128; at d
//   160, where that would take three blocks, into a dV launch (S^T alone)
//   and a dK launch over all d columns.  attn_q_tile_kernel: a block per
//   (b*h, 128 query rows); K and V tiles of 64 keys (32 at d 160) stream
//   through the ring; S = Q K^T and dP = dO V^T as ss products, dS in
//   registers, dQ += dS K as rs with K MN-major.  Every gradient element
//   is summed by one thread in a fixed order, so two runs are bitwise
//   equal.
//
// Bounds (chip_smoke.py's _attn_bound): Phi-4-mini's training backward
// (192 heads, 256^2 causal, d 128) is bound by its 101 MB.
#include "chunked_attention_sm90.cuh"

namespace {

using namespace attn_sm90;

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

// How the blocks of a key tile share its gradients: by 64-column chunks,
// each block summing dK and dV there and recomputing S^T and dP^T
// (kKvCols), or as a dV launch, which needs S^T alone, and a dK launch,
// each summing all d columns (kKvProducts).
enum : int { kKvCols = 0, kKvProducts = 1 };
// what one block of attn_kv_tile_kernel sums (a template argument: no
// product is issued under a run-time condition)
enum : int { kSumBoth = 0, kSumDv = 1, kSumDk = 2 };

// Each width's split, fixed at compile time: at d = 128 the dK and dV accumulators of all columns
// (128 registers a thread) leave ptxas too few registers to pipeline the
// products (C7512), so two blocks take 64 columns each.  At d 160 chunks
// would take three blocks, each recomputing S^T and dP^T; the dV and dK
// launches recompute S^T once and hold 80 accumulators a thread (the dK
// launch takes 32 queries a stage, so that its scores fit beside them:
// with 64 ptxas serialised its products, C7512).  At d 112 the two splits
// timed within 2% of each other on an H100 (PERF.md), and it keeps the
// chunks of d 128.
template <int D>
constexpr int KvPlan = D == 160 ? kKvProducts : kKvCols;

template <int D, int Sum>
struct KvLayout {
  static constexpr int kChunks = chunks_of(D);
  // gradient columns a block, and blocks a key tile
  static constexpr int kCols = Sum == kSumBoth ? 64 : D;
  static constexpr int kParts = Sum == kSumBoth ? kChunks : 1;
  static constexpr bool kDv = Sum != kSumDk, kDk = Sum != kSumDv;
  // queries a stage
  static constexpr int kQN = D == 160 && Sum == kSumDk ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int kKChunk = kKvBK * 128;
  static constexpr int kK = kChunks * kKChunk;  // the K (and the V) tile
  static constexpr int kQChunk = kQN * 128;
  static constexpr int kQ = kChunks * kQChunk;  // a Q (or dO) tile
  static constexpr int kStat = kQN * 4;         // lse2 (or D) of a tile
  static constexpr int kStage = 2 * kQ + 1024;  // Q, dO, lse2, D (padded)
  // K, then V (not loaded by the dV launch: dP^T is the dK launch's)
  static constexpr int kKV = kDk ? 2 * kK : kK;
  static constexpr int kBars = 2 * kK + kStages * kStage;
  // kv, full[S], empty[S]
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int Sum>
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
  using L = KvLayout<D, Sum>;
  constexpr int S = L::kStages, QN = L::kQN, C = L::kCols;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + L::kK, st0 = base + 2 * L::kK;
  const uint32_t kvbar = base + L::kBars;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * S;
  const uint8_t* gen = smem + (base - smem_addr(smem));

  // a head's key tiles side by side (they share its Q and dO in L2)
  const int block = int(blockIdx.x) / L::kParts;
  const int part = int(blockIdx.x) % L::kParts;
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
      mbar_expect_tx(kvbar, L::kKV);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load_3d(sk + c * L::kKChunk, &kmap, kvbar, 64 * c, k0, bh);
        if constexpr (L::kDk)
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
    const uint32_t ka = sk + cw * 64 * 128;
    [[maybe_unused]] const uint32_t va = sv + cw * 64 * 128;

    // this block's gradient columns part * C ... + C - 1: from chunk
    // `part` of the 128-byte-swizzled Q and dO tiles (the dK launch has no
    // dV, the dV launch no dK)
    float dkr[C / 2], dvr[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      if constexpr (L::kDk) dkr[i] = 0.0f;
      if constexpr (L::kDv) dvr[i] = 0.0f;
    }
    if (n_qt > 0) mbar_wait(kvbar, 0);
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % S, qi = i_first + it * QN;
      const uint32_t st = st0 + s * L::kStage;
      const float* ls = reinterpret_cast<const float*>(
          gen + (st - base) + 2 * L::kQ);
      [[maybe_unused]] const float* ds = ls + QN;
      mbar_wait(full0 + 8 * s, (it / S) & 1);

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float stt[QN / 2], dpt[QN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_product<QN>(stt, kmajor(ka, kk, L::kKChunk),
                       kmajor(st, kk, L::kQChunk), kk > 0);
      wgmma_commit();
      if constexpr (L::kDk) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ss_product<QN>(dpt, kmajor(va, kk, L::kKChunk),
                         kmajor(st + L::kQ, kk, L::kQChunk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(stt);
      const bool edge = causal && first_key + 63 > q_offset + qi;
#pragma unroll
      for (int i = 0; i < QN / 2; ++i) {
        const int col = acc_col(i, lane);
        float p = ex2(fmaf(stt[i], scale_log2, -ls[col]));
        if (edge && key0 + acc_row(i) > q_offset + qi + col) p = 0.0f;
        stt[i] = p;
      }
      uint32_t pa[QN / 16][4], da[QN / 16][4];
      if constexpr (L::kDk) {
        wgmma_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int i = 0; i < QN / 2; ++i)
          dpt[i] = stt[i] * (dpt[i] - ds[acc_col(i, lane)]);
        to_frags<QN>(da, dpt);
      }
      if constexpr (L::kDv) to_frags<QN>(pa, stt);

      // dV += P^T dO, dK += dS^T Q (dO and Q MN-major)
      wgmma_fence();
      if constexpr (L::kDv) {
#pragma unroll
        for (int kk = 0; kk < QN / 16; ++kk)
          rs_product<C>(dvr, pa[kk], mnmajor(st + L::kQ + part * L::kQChunk,
                                             kk, L::kQChunk));
      }
      if constexpr (L::kDk) {
#pragma unroll
        for (int kk = 0; kk < QN / 16; ++kk)
          rs_product<C>(dkr, da[kk], mnmajor(st + part * L::kQChunk, kk,
                                             L::kQChunk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (L::kDv) {
        fence_regs(dvr);
        fence_frags(pa);
      }
      if constexpr (L::kDk) {
        fence_regs(dkr);
        fence_frags(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    bf16* dkg = dk + int64_t(bh) * tk * D;
    bf16* dvg = dv + int64_t(bh) * tk * D;
#pragma unroll
    for (int i = 0; i < C / 2; i += 2) {
      const int key = key0 + acc_row(i), col = part * C + acc_col(i, lane);
      // the last chunk's padding columns (d 112 and 160 split by chunks)
      if (key >= tk || (C * L::kParts > D && col >= D)) continue;
      const int64_t at = int64_t(key) * D + col;
      if constexpr (L::kDk)
        *reinterpret_cast<uint32_t*>(dkg + at) =
            pack_bf16(dkr[i] * scale, dkr[i + 1] * scale);
      if constexpr (L::kDv)
        *reinterpret_cast<uint32_t*>(dvg + at) = pack_bf16(dvr[i], dvr[i + 1]);
    }
  }
}

// -------------------------------------------------------------------- dQ

constexpr int kQBQ = 128;  // query rows a block (two warpgroups of 64)

template <int D>
struct QLayout {
  // keys a stage: at d 160 the dQ accumulator (80 registers a thread)
  // leaves room for the scores and dP of 32 keys (with 64 ptxas
  // serialised the products, C7512)
  static constexpr int kBK = D == 160 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int kChunks = chunks_of(D);
  static constexpr int kQChunk = kQBQ * 128;
  static constexpr int kQ = kChunks * kQChunk;  // the Q (and the dO) tile
  static constexpr int kKChunk = kBK * 128;
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
  constexpr int S = L::kStages, BK = L::kBK;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + L::kQ, st0 = base + 2 * L::kQ;
  const uint32_t qbar = base + L::kBars;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * S;

  const int bh = int(blockIdx.x) / q_tiles;
  const int qt = q_tiles - 1 - int(blockIdx.x) % q_tiles;
  const int q0 = qt * kQBQ;
  int n_kt = (tk + BK - 1) / BK;
  if (causal)
    n_kt = min(n_kt, (min(q0 + kQBQ, tq) - 1 + q_offset) / BK + 1);

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
          tma_load_3d(st + c * L::kKChunk, &kmap, full, 64 * c, kt * BK,
                      bh);
          tma_load_3d(st + L::kK + c * L::kKChunk, &vmap, full, 64 * c,
                      kt * BK, bh);
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

      // S = Q K^T and dP = dO V^T: 64 rows x BK keys
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_product<BK>(sc, kmajor(qa, kk, L::kQChunk),
                       kmajor(ks, kk, L::kKChunk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ss_product<BK>(dp, kmajor(doa, kk, L::kQChunk),
                       kmajor(vs, kk, L::kKChunk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      const int k0 = kt * BK;
      const bool edge =
          k0 + BK > tk || (causal && k0 + BK - 1 > first_row + q_offset);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
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
      for (int i = 0; i < BK / 2; ++i)
        dp[i] = sc[i] * (dp[i] - dlr[(i / 2) % 2]);
      uint32_t da[BK / 16][4];
      to_frags<BK>(da, dp);

      // dQ += dS K (K MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
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

// One launch of attn_kv_tile_kernel<D, Sum>: kParts blocks a key tile
template <int D, int Sum>
int kv_launch(const void* q, const void* k, const void* v, const void* dout,
              const float* lse2, const float* delta, void* dk, void* dv,
              int64_t bh, int64_t kv_tiles, int64_t tq, int64_t tq_pad,
              int64_t tk, int causal, int q_offset, float scale,
              float scale_log2, cudaStream_t s) {
  using L = KvLayout<D, Sum>;
  static bool opted[64] = {};
  int err = smem_opt_in(attn_kv_tile_kernel<D, Sum>, L::kSmem, opted);
  if (err) return err;
  if (bh * kv_tiles * L::kParts > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, dom;
  if ((err = map_3d(&qm, q, D, tq, bh, 64, L::kQN))) return err;
  if ((err = map_3d(&dom, dout, D, tq, bh, 64, L::kQN))) return err;
  if ((err = map_3d(&km, k, D, tk, bh, 64, kKvBK))) return err;
  if ((err = map_3d(&vm, v, D, tk, bh, 64, kKvBK))) return err;
  attn_kv_tile_kernel<D, Sum><<<unsigned(bh * kv_tiles * L::kParts),
                                kTileThreads, L::kSmem, s>>>(
      qm, km, vm, dom, lse2, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), int(kv_tiles), int(tq), int(tq_pad), int(tk),
      causal, q_offset, scale, scale_log2);
  return int(cudaGetLastError());
}

template <int D>
int tile_bwd(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* stats, void* dq,
             void* dk, void* dv, int64_t bh, int64_t tq, int64_t tk,
             int causal, int q_offset, void* stream) {
  static bool opted_q[64] = {};
  int err = smem_opt_in(attn_q_tile_kernel<D>, QLayout<D>::kSmem, opted_q);
  if (err) return err;
  const int64_t tq_pad = (tq + kStatRows - 1) / kStatRows * kStatRows;
  const int64_t kv_tiles = (tk + kKvBK - 1) / kKvBK;
  const int64_t q_tiles = (tq + kQBQ - 1) / kQBQ;
  if (bh * q_tiles > 0x7fffffffLL || bh * tq_pad / 8 + 1 > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  float* lse2 = stats;
  float* delta = stats + bh * tq_pad;
  CUtensorMap qq, kq, vq, doq;
  if ((err = map_3d(&qq, q, D, tq, bh, 64, kQBQ))) return err;
  if ((err = map_3d(&doq, dout, D, tq, bh, 64, kQBQ))) return err;
  if ((err = map_3d(&kq, k, D, tk, bh, 64, QLayout<D>::kBK))) return err;
  if ((err = map_3d(&vq, v, D, tk, bh, 64, QLayout<D>::kBK))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(float(D)), scale_log2 = kLog2e * scale;
  attn_stats_kernel<D><<<unsigned((bh * tq_pad + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse2,
      delta, bh, int(tq), int(tq_pad));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  if constexpr (KvPlan<D> == kKvCols) {
    err = kv_launch<D, kSumBoth>(q, k, v, dout, lse2, delta, dk, dv, bh,
                                 kv_tiles, tq, tq_pad, tk, causal, q_offset,
                                 scale, scale_log2, s);
  } else {
    err = kv_launch<D, kSumDv>(q, k, v, dout, lse2, delta, dk, dv, bh,
                               kv_tiles, tq, tq_pad, tk, causal, q_offset,
                               scale, scale_log2, s);
    if (!err)
      err = kv_launch<D, kSumDk>(q, k, v, dout, lse2, delta, dk, dv, bh,
                                 kv_tiles, tq, tq_pad, tk, causal, q_offset,
                                 scale, scale_log2, s);
  }
  if (err) return err;
  attn_q_tile_kernel<D><<<unsigned(bh * q_tiles), kTileThreads,
                          QLayout<D>::kSmem, s>>>(
      qq, kq, vq, doq, lse2, delta, static_cast<bf16*>(dq), int(tq),
      int(tq_pad), int(tk), int(q_tiles), causal, q_offset, scale,
      scale_log2);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout, lse, stats (float32 workspace, 2*B*H*tq_pad with
// tq_pad = tq rounded up to 64), dq, dk, dv; B*H, tq, tk, d (64, 112, 128
// or 160), causal, q_offset; stream
extern "C" int chunked_attention_tile_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* stats, void* dq, void* dk,
    void* dv, long long bh, long long tq, long long tk, long long d,
    long long causal, long long q_offset, void* stream) {
  if (!shapes_ok(bh, tq, tk, q_offset)) return int(cudaErrorInvalidValue);
  const int off = clamp_offset(tk, q_offset), c = causal != 0;
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
#define TILE_BWD(D)                                                        \
  if (d == D)                                                              \
    return tile_bwd<D>(q, k, v, o, dout, l, st, dq, dk, dv, bh, tq, tk, c, \
                       off, stream);
  TILE_BWD(64)
  TILE_BWD(112)
  TILE_BWD(128)
  TILE_BWD(160)
#undef TILE_BWD
  return int(cudaErrorInvalidValue);
}
