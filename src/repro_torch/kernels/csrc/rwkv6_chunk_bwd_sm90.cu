// rwkv6_chunk_bwd_sm90: the RWKV-6 recurrence's backward in chunked form,
// parallel in T, for Hopper (sm_90a).  The `chunked` backward route of
// repro_torch.kernels.scan.rwkv6_scan: bf16 inputs, T >= 2, the route the
// forward's `chunked` kernel (rwkv6_chunk_sm90.cu) takes.
//
// Replaces, for bf16, the step pair of rwkv6_scan.cu (a forward into a
// float32 workspace of every step's state, B * H * T * hd^2 * 4 bytes,
// then a walk back over all T steps in B * H blocks), itself the port of
// the gradient of the `jax.lax.scan` of `rwkv6_block` in
// src/repro/models/ssm.py.  The plain version is
// `ref.rwkv6_scan_bwd_chunked` (the same passes in float32); the route is
// held to autograd through `ref.rwkv6_scan`, in bf16 and in float32 on
// the same values.
//
// With S the state, G its cotangent (G_{t-1} = diag(w_t) G_t + r_t^T dy_t)
// and chunks of C = 16 tokens, units of U = 64 tokens (four chunks):
//
// 1. `rwkv6_bound_kernel`, two sets of B * H blocks side by side, each
//    walking its (batch, head) chunk by chunk with the hd x hd matrix in
//    registers (a TR x TC tile a thread, 256 threads):
//      states, forward:     S <- diag(P) S + (k (.) Q)^T v
//      cotangents, back:    G <- diag(P) G + (r (.) P')^T dy
//    (P the chunk's decay, Q_s = prod_{tau > s} w_tau, P'_s =
//    prod_{tau < s} w_tau), writing the state entering and the cotangent
//    leaving every unit: 2 * B * H * (T / U) * hd^2 * 4 bytes, 134 MB at
//    RWKV-6-7B's width, B = 2, T = 2048, where the step pair's workspace
//    is 4.3 GB.  The last cotangent is the first state's gradient.
// 2. `rwkv6_grad_kernel`, a block per (batch, head, unit): the unit's
//    chunks from the last, each with the state entering it (recomputed
//    from the unit's through the chunks before it) and the cotangent
//    leaving it (carried back), in shared memory.  With p_t, q_t the
//    products of w before and after token t and D[s, t] those strictly
//    between (every one a direct product: no quotient, no log, so w = 0
//    gives exact zeros):
//      dr_t = p_t (S dy_t) + sum_{s<t} D[s,t] k_s (v_s.dy_t) + u k_t (v_t.dy_t)
//      dk_t = q_t (G v_t) + sum_{s>t} D[t,s] r_s (v_t.dy_s) + u r_t (v_t.dy_t)
//      dv_t = (k_t q_t) G + sum_{s>t} score[s][t] dy_s + bonus_t dy_t
//      du  += r_t k_t (v_t.dy_t)
//      dw_t = sum_j G_t[i,j] S_{t-1}[i,j], the states inside the chunk
//             written through the Gram products of what they are made of:
//             p q (S.G rows) + q sum_{s<t} D k_s (G v_s)
//             + p sum_{s>t} D r_s (S dy_s)
//             + sum_{s'<t<s} D[s',t] D[t,s] k_s' r_s (v_s'.dy_s)
//    The products S dy, G v, (k q) G and score^T dy run on the tensor
//    cores as the forward's do (mma.sync TF32, every float32 operand a
//    hi + lo pair); v.dy and the scores (the forward's `chunk_scores`) in
//    float32 on the CUDA cores; the walks over the chunk's tokens (dr, dk,
//    dw, du) take a thread per (channel, token of four).  du's partial
//    sums go to a workspace of (B * T / U, H, hd).
// 3. `colsum_kernel`: du summed over the batch and the units in a fixed
//    order, so du is deterministic; every other gradient is written once.
//
// Bound: at RWKV-6-7B training (B = 2, T = 2048, H = 64, hd = 64) the
// function reads r, k, v, w, dy, u, the state and the last state's
// cotangent and writes dr, dk, dv, dw, du and the first state's
// gradient: 308 MB, 92 us at 3.35 TB/s.  Its products in chunked form
// are 10 hd^2 + 6 C hd operations a (token, head), 12.3 GFLOP, 25 us at
// the TF32 rate: the bytes bound it.  These kernels run the state updates
// in float32 on the CUDA cores and recompute states (the unit's state
// through up to three chunks): 2 * 16,384 chunk steps in B * H = 128
// blocks, then B * H * T / U = 4096 blocks of 256 threads.
#include "rwkv6_chunk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnit = 64;          // tokens a unit: boundaries are kept
constexpr int kPer = kUnit / kC;   // chunks a unit
constexpr int kStages = 2;         // cp.async ring of the boundary pass

template <int TC>
__device__ __forceinline__ void ld_vec(float* dst, const float* src) {
  if constexpr (TC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    dst[0] = f.x;
    dst[1] = f.y;
    dst[2] = f.z;
    dst[3] = f.w;
  } else if constexpr (TC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(src);
    dst[0] = f.x;
    dst[1] = f.y;
  } else {
    dst[0] = src[0];
  }
}

template <int TC>
__device__ __forceinline__ void st_vec(float* dst, const float* src) {
  if constexpr (TC == 4) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (TC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// a thread's TR x TC tile of an hd x hd matrix at rows i0, columns j0,
// row pitch `pitch` floats
template <int TR, int TC>
__device__ __forceinline__ void ld_tile(float (&t)[TR][TC], const float* m,
                                        int pitch, int i0, int j0) {
#pragma unroll
  for (int x = 0; x < TR; ++x) ld_vec<TC>(t[x], m + (i0 + x) * pitch + j0);
}

template <int TR, int TC>
__device__ __forceinline__ void st_tile(float* m, const float (&t)[TR][TC],
                                        int pitch, int i0, int j0) {
#pragma unroll
  for (int x = 0; x < TR; ++x) st_vec<TC>(m + (i0 + x) * pitch + j0, t[x]);
}

// t <- diag(dec) t + a^T v over a chunk, on the thread's tile: a (C x hd)
// float32 with row pitch F, v (C x hd) staged bf16 bits with row pitch P;
// rows past T have a = 0
template <int TR, int TC, int F, int P>
__device__ __forceinline__ void tile_update(float (&t)[TR][TC],
                                            const float* dec, const float* a,
                                            const uint16_t* v, int i0,
                                            int j0) {
#pragma unroll
  for (int x = 0; x < TR; ++x) {
    const float d = dec[i0 + x];
#pragma unroll
    for (int y = 0; y < TC; ++y) t[x][y] *= d;
  }
#pragma unroll
  for (int s = 0; s < kC; ++s) {
    float av[TR], vv[TC];
#pragma unroll
    for (int x = 0; x < TR; ++x) av[x] = a[s * F + i0 + x];
    ld_row<TC>(vv, reinterpret_cast<const bf16*>(v + s * P + j0));
#pragma unroll
    for (int x = 0; x < TR; ++x)
#pragma unroll
      for (int y = 0; y < TC; ++y) t[x][y] = fmaf(av[x], vv[y], t[x][y]);
  }
}

template <int HD>
struct BoundSmem {
  static constexpr int kP = HD + 8;  // bf16 row pitch: 16-byte rows
  static constexpr int kF = HD + 4;  // float row pitch
  uint16_t in[kStages][3][kC][kP];   // k, v, w or r, dy, w (bf16 bits)
  float a[kC][kF];                   // k_s Q_s or r_s P'_s
  float dec[HD];                     // the chunk's decay
};

// Pass 1: blockIdx.y = 0 walks the states forward and writes the state
// entering every unit into ws_s; blockIdx.y = 1 walks the cotangents back
// from ds (or 0), writes the cotangent leaving every unit into ws_g and
// the first state's gradient into ds0.
template <int HD>
__global__ void __launch_bounds__(kThreads)
rwkv6_bound_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ w,
                   const bf16* __restrict__ dy, const float* __restrict__ s0,
                   const float* __restrict__ ds, float* __restrict__ ws_s,
                   float* __restrict__ ws_g, float* __restrict__ ds0,
                   int64_t n_t, int64_t n_h) {
  using Sm = BoundSmem<HD>;
  constexpr int TR = HD / 16, TC = HD / 16;  // 16 x 16 threads of tiles
  constexpr int kV = HD / 8;                 // 16-byte vectors a row
  __shared__ __align__(16) Sm sm;
  const int tid = threadIdx.x;
  const int i0 = (tid >> 4) * TR, j0 = (tid & 15) * TC;
  const bool fwd = blockIdx.y == 0;
  const int64_t bh = blockIdx.x, b = bh / n_h, h = bh % n_h;
  const int64_t stride = n_h * HD, base = (b * n_t * n_h + h) * HD;
  const int64_t n_c = (n_t + kC - 1) / kC, n_u = (n_t + kUnit - 1) / kUnit;
  const bf16* a_src = fwd ? k : r;
  const bf16* v_src = fwd ? v : dy;

  const auto load = [&](int64_t c, int st) {
    for (int e = tid; e < 3 * kC * kV; e += kThreads) {
      const int arr = e / (kC * kV), row = e / kV % kC, vec = e % kV;
      const bf16* src = arr == 0 ? a_src : arr == 1 ? v_src : w;
      const int64_t t = c * kC + row;
      const bool ok = t < n_t;
      cp_async16(&sm.in[st][arr][row][vec * 8],
                 src + base + (ok ? t : 0) * stride + vec * 8, ok);
    }
    cp_async_commit();
  };

  float m[TR][TC];
  const float* init = fwd ? s0 : ds;
  if (init) {
    ld_tile(m, init + bh * HD * HD, HD, i0, j0);
  } else {
#pragma unroll
    for (int x = 0; x < TR; ++x)
#pragma unroll
      for (int y = 0; y < TC; ++y) m[x][y] = 0.f;
  }
  float* out = (fwd ? ws_s : ws_g) + bh * n_u * HD * HD;
  load(fwd ? 0 : n_c - 1, 0);
  for (int64_t it = 0; it < n_c; ++it) {
    const int64_t c = fwd ? it : n_c - 1 - it;
    const int st = it & 1;
    const int valid = static_cast<int>(n_t - c * kC < kC ? n_t - c * kC : kC);
    // the state entering a unit, or the cotangent leaving it
    if (fwd ? c % kPer == 0 : (c == n_c - 1 || c % kPer == kPer - 1))
      st_tile(out + (c / kPer) * HD * HD, m, HD, i0, j0);
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; the last chunk's readers are done
    if (it + 1 < n_c) load(fwd ? c + 1 : c - 1, st ^ 1);
    if (tid < HD) {
      const auto in_a = sm.in[st][0];
      const auto in_w = sm.in[st][2];
      float p = 1.f;
      if (fwd) {
#pragma unroll
        for (int t = kC - 1; t >= 0; --t) {
          sm.a[t][tid] = bfu(in_a[t][tid]) * p;
          p *= t < valid ? bfu(in_w[t][tid]) : 1.f;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          sm.a[t][tid] = bfu(in_a[t][tid]) * p;
          p *= t < valid ? bfu(in_w[t][tid]) : 1.f;
        }
      }
      sm.dec[tid] = p;
    }
    __syncthreads();
    tile_update<TR, TC, Sm::kF, Sm::kP>(m, sm.dec, &sm.a[0][0],
                                         &sm.in[st][1][0][0], i0, j0);
  }
  if (!fwd) st_tile(ds0 + bh * HD * HD, m, HD, i0, j0);
}

template <int HD>
struct GradSmem {
  static constexpr int kP = HD + 8;  // bf16 row pitch: 16-byte rows
  static constexpr int kF = HD + 4;  // float row pitch: conflict-free rows
  uint16_t in[5][kC][kP];  // r, k, v, w, dy of a chunk (bf16 bits)
  float s[HD][kF];         // the state entering the chunk
  float g[HD][kF];         // the cotangent leaving it
  float kq[kC][kF];        // k_t q_t
  float rp[kC][kF];        // r_t p_t
  float ds[kC][kF];        // (S dy_t)[i]
  float gv[kC][kF];        // (G v_t)[i]
  float kg[kC][kF];        // ((k_t q_t) G)[j]
  float vdy[kC][kC + 1];   // v_s . dy_t
  float sc[kC][kC + 4];    // the scores; the diagonal is the bonus
  float dec[HD];           // the chunk's decay
  float u[HD];
  float sg[HD];            // sum_j S[i,j] G[i,j]
  float du[kThreads];      // du by (part, channel)
};

// Pass 2: a block per (batch, head) x unit
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_grad_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ w,
                  const bf16* __restrict__ u, const bf16* __restrict__ dy,
                  const float* __restrict__ ws_s,
                  const float* __restrict__ ws_g, bf16* __restrict__ dr,
                  bf16* __restrict__ dk, bf16* __restrict__ dv,
                  bf16* __restrict__ dw, float* __restrict__ du_ws,
                  int64_t n_t, int64_t n_h) {
  using Sm = GradSmem<HD>;
  constexpr int kP = Sm::kP, kF = Sm::kF;
  constexpr int TR = HD / 16, TC = HD / 16;
  constexpr int kV = HD / 8;
  constexpr int kParts = kThreads / HD;  // threads a channel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = (tid >> 4) * TR, j0 = (tid & 15) * TC;
  const int ci = tid % HD, part = tid / HD;
  const int64_t bh = blockIdx.x, b = bh / n_h, h = bh % n_h;
  const int64_t n = blockIdx.y;
  const int64_t stride = n_h * HD, base = (b * n_t * n_h + h) * HD;
  const int64_t n_c = (n_t + kC - 1) / kC, n_u = (n_t + kUnit - 1) / kUnit;
  const int per = static_cast<int>(n_c - n * kPer < kPer ? n_c - n * kPer
                                                         : kPer);
  using Row = const uint16_t(*)[kP];
  Row in_r = sm.in[0], in_k = sm.in[1], in_v = sm.in[2], in_w = sm.in[3],
      in_dy = sm.in[4];
  using BRow = const bf16(*)[kP];

  // arrays [first, first + count) of chunk c into sm.in, then a barrier
  const auto stage = [&](int64_t c, int first, int count) {
    for (int e = tid; e < count * kC * kV; e += kThreads) {
      const int arr = first + e / (kC * kV), row = e / kV % kC, vec = e % kV;
      const bf16* src = arr == 0   ? r
                        : arr == 1 ? k
                        : arr == 2 ? v
                        : arr == 3 ? w
                                   : dy;
      const int64_t t = c * kC + row;
      const bool ok = t < n_t;
      cp_async16(&sm.in[arr][row][vec * 8],
                 src + base + (ok ? t : 0) * stride + vec * 8, ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };

  if (tid < HD) sm.u[tid] = __bfloat162float(u[h * HD + tid]);
  const float* unit_s = ws_s + (bh * n_u + n) * HD * HD;
  float gt[TR][TC];  // the cotangent leaving the chunk
  ld_tile(gt, ws_g + (bh * n_u + n) * HD * HD, HD, i0, j0);
  float du_acc = 0.f;

  for (int j = per - 1; j >= 0; --j) {
    const int64_t c = n * kPer + j;
    const int valid = static_cast<int>(n_t - c * kC < kC ? n_t - c * kC : kC);
    // the state entering chunk c, from the unit's through its chunks
    // before c (each full: a later chunk holds tokens)
    float st[TR][TC];
    ld_tile(st, unit_s, HD, i0, j0);
    for (int x = 0; x < j; ++x) {
      stage(n * kPer + x, 1, 3);
      if (tid < HD) {
        float q = 1.f;
#pragma unroll
        for (int t = kC - 1; t >= 0; --t) {
          sm.kq[t][tid] = bfu(in_k[t][tid]) * q;
          q *= bfu(in_w[t][tid]);
        }
        sm.dec[tid] = q;
      }
      __syncthreads();
      tile_update<TR, TC, kF, kP>(st, sm.dec, &sm.kq[0][0], &in_v[0][0],
                                   i0, j0);
      __syncthreads();
    }
    stage(c, 0, 5);

    // (a) the decays; S and G into shared memory
    if (tid < HD) {
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        sm.rp[t][tid] = bfu(in_r[t][tid]) * p;
        p *= t < valid ? bfu(in_w[t][tid]) : 1.f;
      }
      sm.dec[tid] = p;
    } else if (tid < 2 * HD) {
      const int i = tid - HD;
      float q = 1.f;
#pragma unroll
      for (int t = kC - 1; t >= 0; --t) {
        sm.kq[t][i] = bfu(in_k[t][i]) * q;
        q *= t < valid ? bfu(in_w[t][i]) : 1.f;
      }
    }
    st_tile(&sm.s[0][0], st, kF, i0, j0);
    st_tile(&sm.g[0][0], gt, kF, i0, j0);
    __syncthreads();

    // (b) the scores (threads 0-127) and v_s . dy_t (128-255), then the
    // products S dy, G v, (k q) G (the tensor cores) and the rows' S.G
    if (tid < 128) {
      chunk_scores<HD, kP>(reinterpret_cast<BRow>(in_r),
                           reinterpret_cast<BRow>(in_k),
                           reinterpret_cast<BRow>(in_w), sm.u, sm.sc, tid);
    } else {
      for (int o = tid - 128; o < kC * kC; o += 128) {
        const int s = o / kC, t = o % kC;
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < HD; x += 4) {
          float va[4], da[4];
          ld_row<4>(va, reinterpret_cast<const bf16*>(&in_v[s][x]));
          ld_row<4>(da, reinterpret_cast<const bf16*>(&in_dy[t][x]));
#pragma unroll
          for (int y = 0; y < 4; ++y) acc = fmaf(va[y], da[y], acc);
        }
        sm.vdy[s][t] = acc;
      }
    }
    // the products on the tensor cores (mma.sync m16n8k8, TF32 operands,
    // float32 accumulators; the float32 S, G and k q as hi + lo pairs, dy
    // and v bf16 and so exact): warp `warp` takes tile `warp` (16 x 8) of
    // each of S dy^T and G v^T (channels i x tokens) and (k q) G (tokens x
    // channels j); each has HD / 8 tiles
    if (warp < HD / 8) {
      const int g = lane >> 2, q = lane & 3;
      const int m0 = (warp >> 1) * 16, n0 = (warp & 1) * 8;
      float dsa[4] = {}, dsb[4] = {}, gva[4] = {}, gvb[4] = {};
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const float sv[4] = {sm.s[m0 + g][kk + q], sm.s[m0 + g + 8][kk + q],
                             sm.s[m0 + g][kk + q + 4],
                             sm.s[m0 + g + 8][kk + q + 4]};
        const float gv[4] = {sm.g[m0 + g][kk + q], sm.g[m0 + g + 8][kk + q],
                             sm.g[m0 + g][kk + q + 4],
                             sm.g[m0 + g + 8][kk + q + 4]};
        uint32_t shi[4], slo[4], ghi[4], glo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          split(sv[x], shi[x], slo[x]);
          split(gv[x], ghi[x], glo[x]);
        }
        const uint32_t d0 = static_cast<uint32_t>(in_dy[n0 + g][kk + q]) << 16;
        const uint32_t d1 = static_cast<uint32_t>(in_dy[n0 + g][kk + q + 4])
                            << 16;
        const uint32_t v0 = static_cast<uint32_t>(in_v[n0 + g][kk + q]) << 16;
        const uint32_t v1 = static_cast<uint32_t>(in_v[n0 + g][kk + q + 4])
                            << 16;
        mma_tf32(dsb, slo, d0, d1);
        mma_tf32(dsa, shi, d0, d1);
        mma_tf32(gvb, glo, v0, v1);
        mma_tf32(gva, ghi, v0, v1);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = m0 + g + (x >> 1) * 8, t = n0 + 2 * q + (x & 1);
        sm.ds[t][i] = dsa[x] + dsb[x];
        sm.gv[t][i] = gva[x] + gvb[x];
      }
      const int nj = warp * 8;
      float kga[4] = {}, kgb[4] = {}, kgc[4] = {};
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const float kv[4] = {sm.kq[g][kk + q], sm.kq[g + 8][kk + q],
                             sm.kq[g][kk + q + 4], sm.kq[g + 8][kk + q + 4]};
        uint32_t khi[4], klo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split(kv[x], khi[x], klo[x]);
        uint32_t b0, b0lo, b1, b1lo;
        split(sm.g[kk + q][nj + g], b0, b0lo);
        split(sm.g[kk + q + 4][nj + g], b1, b1lo);
        mma_tf32(kgb, klo, b0, b1);
        mma_tf32(kgc, khi, b0lo, b1lo);
        mma_tf32(kga, khi, b0, b1);
      }
      *reinterpret_cast<float2*>(&sm.kg[g][nj + 2 * q]) =
          make_float2(kga[0] + kgb[0] + kgc[0], kga[1] + kgb[1] + kgc[1]);
      *reinterpret_cast<float2*>(&sm.kg[g + 8][nj + 2 * q]) =
          make_float2(kga[2] + kgb[2] + kgc[2], kga[3] + kgb[3] + kgc[3]);
    }
    if (tid < HD) {
      float acc = 0.f;
#pragma unroll 4
      for (int x = 0; x < HD; x += 4) {
        float s4[4], g4[4];
        ld_vec<4>(s4, &sm.s[tid][x]);
        ld_vec<4>(g4, &sm.g[tid][x]);
#pragma unroll
        for (int y = 0; y < 4; ++y) acc = fmaf(s4[y], g4[y], acc);
      }
      sm.sg[tid] = acc;
    }
    __syncthreads();

    // (c) dv = (k q) G + sc^T dy on the tensor cores (the scores' upper
    // triangle and the rows past T are 0): warp `warp` takes channels
    // 8 warp .. 8 warp + 7 of all 16 tokens; then the walks
    if (warp < HD / 8) {
      const int g = lane >> 2, q = lane & 3, nj = warp * 8 + 2 * q;
      float da[4] = {sm.kg[g][nj], sm.kg[g][nj + 1], sm.kg[g + 8][nj],
                     sm.kg[g + 8][nj + 1]};
      float db[4] = {};
#pragma unroll
      for (int ks = 0; ks < kC; ks += 8) {
        const float sv[4] = {sm.sc[ks + q][g], sm.sc[ks + q][g + 8],
                             sm.sc[ks + q + 4][g], sm.sc[ks + q + 4][g + 8]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split(sv[x], hi[x], lo[x]);
        const uint32_t b0 = static_cast<uint32_t>(in_dy[ks + q][warp * 8 + g])
                            << 16;
        const uint32_t b1 =
            static_cast<uint32_t>(in_dy[ks + q + 4][warp * 8 + g]) << 16;
        mma_tf32(db, lo, b0, b1);
        mma_tf32(da, hi, b0, b1);
      }
      bf16* out = dv + base + (c * kC + g) * stride + nj;
      if (g < valid)
        *reinterpret_cast<__nv_bfloat162*>(out) =
            __floats2bfloat162_rn(da[0] + db[0], da[1] + db[1]);
      if (g + 8 < valid)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * stride) =
            __floats2bfloat162_rn(da[2] + db[2], da[3] + db[3]);
    }
    // the walks: channel ci, tokens t with t % kParts == part
    {
      const float ui = sm.u[ci], sgi = sm.sg[ci];
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        if (t % kParts != part || t >= valid) continue;
        float al[kC], be[kC];
        float d = 1.f, dr_i = 0.f, t2 = 0.f;
#pragma unroll
        for (int s = t - 1; s >= 0; --s) {  // D[s, t] k_s
          al[s] = d * bfu(in_k[s][ci]);
          dr_i = fmaf(al[s], sm.vdy[s][t], dr_i);
          t2 = fmaf(al[s], sm.gv[s][ci], t2);
          d *= bfu(in_w[s][ci]);
        }
        const float p = d;
        d = 1.f;
        float dk_i = 0.f, t3 = 0.f;
#pragma unroll
        for (int s = t + 1; s < kC; ++s) {  // D[t, s] r_s
          be[s] = d * bfu(in_r[s][ci]);
          dk_i = fmaf(be[s], sm.vdy[t][s], dk_i);
          t3 = fmaf(be[s], sm.ds[s][ci], t3);
          d *= s < valid ? bfu(in_w[s][ci]) : 1.f;
        }
        const float q = d;
        float t4 = 0.f;
#pragma unroll
        for (int a = 0; a < t; ++a) {
          float cc = 0.f;
#pragma unroll
          for (int s = t + 1; s < kC; ++s)
            cc = fmaf(be[s], sm.vdy[a][s], cc);
          t4 = fmaf(al[a], cc, t4);
        }
        const float diag = sm.vdy[t][t];
        const float rt = bfu(in_r[t][ci]), kt = bfu(in_k[t][ci]);
        const int64_t o = base + (c * kC + t) * stride + ci;
        dr[o] = __float2bfloat16(p * sm.ds[t][ci] + dr_i + ui * kt * diag);
        dk[o] = __float2bfloat16(q * sm.gv[t][ci] + dk_i + ui * rt * diag);
        dw[o] = __float2bfloat16(p * q * sgi + q * t2 + p * t3 + t4);
        du_acc = fmaf(rt * kt, diag, du_acc);
      }
    }

    // (d) the cotangent leaving chunk c - 1: G <- diag(P) G + (r p)^T dy
    tile_update<TR, TC, kF, kP>(gt, sm.dec, &sm.rp[0][0], &in_dy[0][0], i0,
                                 j0);
    __syncthreads();
  }
  sm.du[tid] = du_acc;
  __syncthreads();
  if (tid < HD) {
    float acc = 0.f;
#pragma unroll
    for (int x = 0; x < kParts; ++x) acc += sm.du[x * HD + tid];
    du_ws[((b * n_u + n) * n_h + h) * HD + tid] = acc;
  }
}

template <int HD>
int backward(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, const void* dy, const void* ds,
             void* ws, void* dr, void* dk, void* dv, void* dw, void* du,
             void* ds0, int64_t n_b, int64_t n_t, int64_t n_h,
             cudaStream_t st) {
  const auto rp = static_cast<const bf16*>(r), kp = static_cast<const bf16*>(k),
             vp = static_cast<const bf16*>(v), wp = static_cast<const bf16*>(w),
             dyp = static_cast<const bf16*>(dy);
  const int64_t n_u = (n_t + kUnit - 1) / kUnit;
  const int64_t mat = n_b * n_h * n_u * HD * HD;
  float* ws_s = static_cast<float*>(ws);
  float* ws_g = ws_s + mat;
  float* du_ws = ws_g + mat;
  rwkv6_bound_kernel<HD><<<dim3(n_b * n_h, 2), kThreads, 0, st>>>(
      rp, kp, vp, wp, dyp, static_cast<const float*>(s0),
      static_cast<const float*>(ds), ws_s, ws_g, static_cast<float*>(ds0),
      n_t, n_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(sizeof(GradSmem<HD>));
  err = cudaFuncSetAttribute(rwkv6_grad_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  rwkv6_grad_kernel<HD><<<dim3(n_b * n_h, n_u), kThreads, smem, st>>>(
      rp, kp, vp, wp, static_cast<const bf16*>(u), dyp, ws_s, ws_g,
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(dw), du_ws, n_t, n_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t cols = n_h * HD;
  colsum_kernel<<<(cols + 255) / 256, 256, 0, st>>>(
      du_ws, static_cast<float*>(du), n_b * n_u, cols);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy (B, T, H, hd) and u (H, hd) bf16, 16-byte aligned; s0
// (B, H, hd, hd) float32, ds float32 or null; ws float32 of
// 2 * B * H * ceil(T / 64) * hd^2 + B * ceil(T / 64) * H * hd; dr, dk, dv,
// dw bf16 like r; du float32 (H, hd); ds0 float32 like s0; B, T (>= 1), H,
// hd; stream
extern "C" int rwkv6_scan_bwd_chunked_bf16(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds, void* ws,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0, int64_t n_b,
    int64_t n_t, int64_t n_h, int64_t hd, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_b * n_h == 0) return 0;
  if (n_t < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return backward<16>(r, k, v, w, u, s0, dy, ds, ws, dr, dk, dv, dw, du,
                          ds0, n_b, n_t, n_h, st);
    case 32:
      return backward<32>(r, k, v, w, u, s0, dy, ds, ws, dr, dk, dv, dw, du,
                          ds0, n_b, n_t, n_h, st);
    case 64:
      return backward<64>(r, k, v, w, u, s0, dy, ds, ws, dr, dk, dv, dw, du,
                          ds0, n_b, n_t, n_h, st);
    default:
      return cudaErrorInvalidValue;
  }
}
