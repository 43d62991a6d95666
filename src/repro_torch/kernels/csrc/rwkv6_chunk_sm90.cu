// rwkv6_chunk_sm90: the RWKV-6 recurrence's forward in chunked form, on the
// tensor cores (TF32), for Hopper (sm_90a).  The `chunked` route of
// repro_torch.kernels.scan.rwkv6_scan: bf16 inputs, T >= 2.
//
// Replaces, for bf16 prefill, the step-serial forward of rwkv6_scan.cu
// (`rwkv6_fwd_kernel`), itself the port of the `jax.lax.scan` of
// `rwkv6_block` in src/repro/models/ssm.py.  The plain version is
// `ref.rwkv6_scan_chunked` (the same factorisation in float32); the route
// is held to `ref.rwkv6_scan` run in float32 on the same bf16 values.
//
// With S the float32 state entering a chunk of C = 16 tokens (local index
// t = 0..15), P_t = prod_{tau <= t} w_tau and Q_s = prod_{s < tau < C} w_tau
// (per key channel i):
//
//   y_t = (r_t (.) P_{t-1}) S + sum_{s < t} score[t][s] v_s + score[t][t] v_t
//   score[t][s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i]
//   score[t][t] = sum_i r_t[i] u[i] k_t[i]          (the bonus)
//   S <- diag(P_{C-1}) S + sum_s (k_s (.) Q_s)^T v_s
//
// Every decay factor is a product of w's taken directly, never a quotient
// of two products nor the exponential of a difference of log sums: each is
// at most 1 when w <= 1, nothing overflows as w -> 0, and w = 0 gives exact
// zeros, so no log-w floor is needed.
//
// Design.  One block of four warps per (batch, head) walks T in chunks of
// 16 tokens; the state's hd x hd float32 values stay in registers as mma
// accumulators (warp m holds rows 16m..16m+15).  A chunk's r, k, v, w tiles
// (16 tokens x hd, rows H * hd elements apart) arrive by cp.async, 16 bytes
// a thread, double-buffered, so the next chunk loads while this one
// computes.  Per chunk:
//  (a) the decays: thread (i, prefix) writes r_t P_{t-1} and the chunk's
//      product, thread (i, suffix) k_s Q_s, 16 serial multiplies each;
//  (b) the state entering the chunk into shared memory for the read-out;
//  (c) the 16 x 16 scores in float32 on the CUDA cores: thread (tq, group of
//      hd/16 channels) takes tokens tq and 15 - tq (15 key steps in all),
//      walking s down from t - 1 so each step multiplies its decay by one
//      w; the channel groups meet in a butterfly reduce-scatter of warp
//      shuffles;
//  (d) on the tensor cores, mma.sync m16n8k8 TF32 with float32
//      accumulators: the state update (diag(P) S + kd^T V, into the state's
//      registers), the read-out (r P) S, and scores * V.  Every float32
//      operand goes in as a hi + lo pair of tf32 values (3 products for
//      the read-out, 2 where the other operand is V, bf16 and so exact in
//      tf32), which keeps the products to about 2**-20 of float32: with a
//      single TF32 product (2**-11) the bf16-rounded y of a long sequence
//      of decays near 1 came out further from the float32 loop than the
//      bf16 loop's own y.
// The step route's bf16 roundings of k.v and S + u.kv (2**-9) are gone,
// so the route sits closer to the float32 loop than the bf16 loop does.
//
// Carrying the state every 16 tokens, rather than every 64 with 16-token
// sub-chunks, removes the cross-sub-chunk score blocks (each needs its own
// decay-split copy of k) for the same tensor-core work per token (2 hd^2
// multiply-adds in the state products) and a serial pass of T / 16 steps,
// each an elementwise scale-and-add of the state plus its products.
//
// Bound: at RWKV-6-7B prefill (B = 8, T = 512, H = 64, hd = 64) the
// function reads r, k, v, w, u and the state and writes y and the state,
// 184.6 MB, 55.1 us at 3.35 TB/s; its products in this form are
// 4 hd^2 + 4 C hd = 20,480 operations a (token, head), 5.37 GFLOP, 10.9 us
// at 495 TFLOP/s (TF32): the bytes bound it.  B * H blocks of 128 threads
// (512 at prefill), four resident on an SM (47.6 KB of shared memory each).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kC = 16;         // tokens a chunk
constexpr int kThreads = 128;  // four warps
constexpr int kStages = 2;     // cp.async ring of chunk tiles

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// bf16 bits as float32 bits: exact, so exact in tf32 as well
__device__ __forceinline__ uint32_t bf_bits(bf16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

// x as a pair of tf32 operands, hi + lo: hi is x with its low 13 mantissa
// bits cut, lo = x - hi exactly, and the tensor core reads lo to tf32
// precision, so hi + lo is x to 2**-20.  Two instructions, where each
// cvt.rna.tf32 is four.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// D += A B, m16n8k8, A row-major (16 x 8), B column-major (8 x 8), TF32
// operands, float32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// N channels of one staged bf16 row as float32
template <int N>
__device__ __forceinline__ void ld_row(float (&out)[N], const bf16* p) {
  if constexpr (N == 1) {
    out[0] = bf(p[0]);
  } else {
#pragma unroll
    for (int x = 0; x < N; x += 2) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + x));
      out[x] = f.x;
      out[x + 1] = f.y;
    }
  }
}

// c ? a : b as one selp, so that the compiler cannot turn a choice
// between two elements of a register array into an indexed load from
// local memory
__device__ __forceinline__ float sel(bool c, float a, float b) {
  float out;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n"
      " selp.f32 %0, %2, %3, p;\n}"
      : "=f"(out) : "r"(static_cast<uint32_t>(c)), "f"(a), "f"(b));
  return out;
}

// One level of the butterfly below: lanes that differ in lane bit M trade
// halves p[0..M) and p[M..2M) and keep the sum of theirs
template <int V, int M>
__device__ __forceinline__ void reduce_level(float (&p)[V], int lane) {
  const bool hi = lane & M;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const float send = sel(hi, p[q], p[q + M]);
    const float keep = sel(hi, p[q + M], p[q]);
    p[q] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > 1) reduce_level<V, M / 2>(p, lane);
}

// Sum V values p[0..V) over the lanes that differ in the low log2(V) lane
// bits (a butterfly reduce-scatter): the result is the sum of index
// lane % V.  V - 1 shuffles.  Each level is its own instance, so every
// index is a constant and p stays in registers.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&p)[V], int lane) {
  reduce_level<V, V / 2>(p, lane);
  return p[0];
}

template <int HD>
struct Tiles {
  static constexpr int kP = HD + 8;  // row pitch: conflict-free fragments
  uint16_t in[kStages][4][kC][kP];   // r, k, v, w of a chunk (bf16 bits)
  float a[kC][HD + 4];               // r_t P_{t-1}
  float kd[kC][kP];                  // k_s Q_s
  float s[HD][kP];                   // S entering the chunk
  float sc[kC][kC + 4];              // scores; the diagonal is the bonus
  float dec[HD];                     // P_{C-1}: the chunk's decay
  float u[HD];
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 4)
rwkv6_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ w,
                   const bf16* __restrict__ u, const float* __restrict__ s0,
                   bf16* __restrict__ y, float* __restrict__ s_out,
                   int64_t n_t, int64_t n_h) {
  constexpr int kP = Tiles<HD>::kP;
  constexpr int kMT = HD / 16;              // warps that hold the state
  constexpr int kNT = HD / 8;               // 8-column tiles of S and y
  constexpr int kYW = kNT < 4 ? kNT : 4;    // warps that compute y
  constexpr int kYT = kNT / kYW;            // y's column tiles a warp
  constexpr int kCH = HD / 16;              // channels a thread in (c)
  constexpr int kV = HD / 8;                // 16-byte vectors a row
  static_assert(kMT * 32 <= kThreads && kYW * kYT == kNT &&
                    4 * kC * kV % kThreads == 0, "tiling");
  __shared__ __align__(16) Tiles<HD> sm;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;  // mma fragment coordinates
  const int64_t bh = blockIdx.x, b = bh / n_h, h = bh % n_h;
  const int64_t stride = n_h * HD;               // elements a token
  const int64_t base = (b * n_t * n_h + h) * HD;  // token 0 of (b, h)
  const int64_t n_c = (n_t + kC - 1) / kC;

  const auto load = [&](int64_t c, int st) {
#pragma unroll
    for (int it = 0; it < 4 * kC * kV / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int arr = e / (kC * kV), row = e / kV % kC, vec = e % kV;
      const bf16* src = arr == 0 ? r : arr == 1 ? k : arr == 2 ? v : w;
      const int64_t t = c * kC + row;
      const bool ok = t < n_t;
      cp_async16(&sm.in[st][arr][row][vec * 8],
                 src + base + (ok ? t : 0) * stride + vec * 8, ok);
    }
    cp_async_commit();
  };

  // the state: warp m < kMT holds rows r0 and r0 + 8 of each column tile
  const bool owner = warp < kMT;
  const int r0 = 16 * warp + g;
  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    if (owner) {
      const float* p = s0 + (bh * HD + r0) * HD + 8 * nt + 2 * q;
      const float2 lo = *reinterpret_cast<const float2*>(p);
      const float2 hi = *reinterpret_cast<const float2*>(p + 8 * HD);
      acc[nt][0] = lo.x;
      acc[nt][1] = lo.y;
      acc[nt][2] = hi.x;
      acc[nt][3] = hi.y;
    } else {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
  }
  if (tid < HD) sm.u[tid] = bf(u[h * HD + tid]);
  load(0, 0);

  for (int64_t c = 0; c < n_c; ++c) {
    const int st = c & 1;
    const int valid = static_cast<int>(n_t - c * kC < kC ? n_t - c * kC : kC);
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's readers are done
    if (c + 1 < n_c) load(c + 1, st ^ 1);
    using Row = const bf16(*)[kP];
    const auto in_r = reinterpret_cast<Row>(sm.in[st][0]);
    const auto in_k = reinterpret_cast<Row>(sm.in[st][1]);
    const auto in_v = reinterpret_cast<Row>(sm.in[st][2]);
    const auto in_w = reinterpret_cast<Row>(sm.in[st][3]);

    // (a) the decays; rows past T decay by 1 (their r and k are zeros)
    if (tid < HD) {
      float p = 1.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        sm.a[t][tid] = bf(in_r[t][tid]) * p;
        p *= t < valid ? bf(in_w[t][tid]) : 1.f;
      }
      sm.dec[tid] = p;
    } else if (tid < 2 * HD) {
      const int i = tid - HD;
      float p = 1.f;
#pragma unroll
      for (int t = kC - 1; t >= 0; --t) {
        sm.kd[t][i] = bf(in_k[t][i]) * p;
        p *= t < valid ? bf(in_w[t][i]) : 1.f;
      }
    }

    // (b) the state entering the chunk, for the read-out
    if (owner) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float* p = &sm.s[r0][8 * nt + 2 * q];
        *reinterpret_cast<float2*>(p) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(p + 8 * kP) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }

    // (c) the scores, float32: tokens ta = tq and tb = 15 - tq, channels
    // [cg * kCH, cg * kCH + kCH)
    {
      const int tq = tid >> 4, cg = tid & 15;
      const int ta = tq, tb = kC - 1 - tq;
      const int i0 = cg * kCH;
      float pa[kC / 2], pb[kC];
#pragma unroll
      for (int x = 0; x < kC; ++x) {
        pb[x] = 0.f;
        if (x < kC / 2) pa[x] = 0.f;
      }
      float ra[kCH], rb[kCH], ka[kCH], kb[kCH], da[kCH], db[kCH];
      ld_row(ra, &in_r[ta][i0]);
      ld_row(rb, &in_r[tb][i0]);
      ld_row(ka, &in_k[ta][i0]);
      ld_row(kb, &in_k[tb][i0]);
      float bonus_a = 0.f, bonus_b = 0.f;
#pragma unroll
      for (int x = 0; x < kCH; ++x) {
        const float ui = sm.u[i0 + x];
        bonus_a = fmaf(ra[x] * ui, ka[x], bonus_a);
        bonus_b = fmaf(rb[x] * ui, kb[x], bonus_b);
        da[x] = db[x] = 1.f;
      }
      // s walks down from t - 1: the factor of s is prod_{s < tau < t}
#pragma unroll
      for (int s = kC - 2; s >= 0; --s) {
        float ks[kCH], ws[kCH];
        ld_row(ks, &in_k[s][i0]);
        ld_row(ws, &in_w[s][i0]);
        if (s < tb) {
#pragma unroll
          for (int x = 0; x < kCH; ++x) {
            pb[s] = fmaf(rb[x] * ks[x], db[x], pb[s]);
            db[x] *= ws[x];
          }
        }
        if (s < kC / 2 - 1 && s < ta) {
#pragma unroll
          for (int x = 0; x < kCH; ++x) {
            pa[s] = fmaf(ra[x] * ks[x], da[x], pa[s]);
            da[x] *= ws[x];
          }
        }
      }
      const float sb = reduce_scatter<kC>(pb, lane);
      float sa = reduce_scatter<kC / 2>(pa, lane);
      sa += __shfl_xor_sync(0xffffffffu, sa, kC / 2);
      // the bonuses sum over the group's 16 lanes and join the diagonal in
      // the lane of its column (a register array indexed by ta or tb
      // would live in local memory)
#pragma unroll
      for (int m = kC / 2; m >= 1; m /= 2) {
        bonus_a += __shfl_xor_sync(0xffffffffu, bonus_a, m);
        bonus_b += __shfl_xor_sync(0xffffffffu, bonus_b, m);
      }
      sm.sc[tb][cg] = cg == tb ? sb + bonus_b : sb;
      sm.sc[ta][cg] = cg == ta ? sa + bonus_a : cg < kC / 2 ? sa : 0.f;
    }
    __syncthreads();

    // (d) the state update: S <- diag(P) S + kd^T V
    if (owner) {
      const float d0 = sm.dec[r0], d1 = sm.dec[r0 + 8];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[nt][0] *= d0;
        acc[nt][1] *= d0;
        acc[nt][2] *= d1;
        acc[nt][3] *= d1;
      }
#pragma unroll
      for (int ks = 0; ks < kC; ks += 8) {
        const float kv[4] = {sm.kd[ks + q][r0], sm.kd[ks + q][r0 + 8],
                             sm.kd[ks + q + 4][r0], sm.kd[ks + q + 4][r0 + 8]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split(kv[x], hi[x], lo[x]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const uint32_t b0 = bf_bits(in_v[ks + q][8 * nt + g]);
          const uint32_t b1 = bf_bits(in_v[ks + q + 4][8 * nt + g]);
          mma_tf32(acc[nt], lo, b0, b1);
          mma_tf32(acc[nt], hi, b0, b1);
        }
      }
    }

    // the read-out (r P) S plus scores * V, written as bf16
    if (warp < kYW) {
      // three independent accumulator chains a tile (the hi x hi, lo x hi
      // and hi x lo products), summed at the end
      float ya[kYT][4], yb[kYT][4], yc[kYT][4];
#pragma unroll
      for (int j = 0; j < kYT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) ya[j][x] = yb[j][x] = yc[j][x] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        const float av[4] = {sm.a[g][kk + q], sm.a[g + 8][kk + q],
                             sm.a[g][kk + q + 4], sm.a[g + 8][kk + q + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split(av[x], ahi[x], alo[x]);
#pragma unroll
        for (int j = 0; j < kYT; ++j) {
          const int col = 8 * (warp * kYT + j) + g;
          uint32_t b0, b0lo, b1, b1lo;
          split(sm.s[kk + q][col], b0, b0lo);
          split(sm.s[kk + q + 4][col], b1, b1lo);
          mma_tf32(yb[j], alo, b0, b1);
          mma_tf32(yc[j], ahi, b0lo, b1lo);
          mma_tf32(ya[j], ahi, b0, b1);
        }
      }
#pragma unroll
      for (int ks = 0; ks < kC; ks += 8) {
        const float sv[4] = {sm.sc[g][ks + q], sm.sc[g + 8][ks + q],
                             sm.sc[g][ks + q + 4], sm.sc[g + 8][ks + q + 4]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split(sv[x], hi[x], lo[x]);
#pragma unroll
        for (int j = 0; j < kYT; ++j) {
          const int col = 8 * (warp * kYT + j) + g;
          const uint32_t b0 = bf_bits(in_v[ks + q][col]);
          const uint32_t b1 = bf_bits(in_v[ks + q + 4][col]);
          mma_tf32(yb[j], lo, b0, b1);
          mma_tf32(yc[j], hi, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < kYT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) ya[j][x] += yb[j][x] + yc[j][x];
#pragma unroll
      for (int j = 0; j < kYT; ++j) {
        const int col = 8 * (warp * kYT + j) + 2 * q;
        bf16* out = y + base + (c * kC + g) * stride + col;
        if (g < valid)
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(ya[j][0], ya[j][1]);
        if (g + 8 < valid)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * stride) =
              __floats2bfloat162_rn(ya[j][2], ya[j][3]);
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float* p = s_out + (bh * HD + r0) * HD + 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(p) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(p + 8 * HD) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

template <int HD>
int chunked(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* s0, void* y, void* s_out, int64_t n_b,
            int64_t n_t, int64_t n_h, cudaStream_t st) {
  rwkv6_chunk_kernel<HD><<<n_b * n_h, kThreads, 0, st>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(w),
      static_cast<const bf16*>(u), static_cast<const float*>(s0),
      static_cast<bf16*>(y), static_cast<float*>(s_out), n_t, n_h);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w (B, T, H, hd) and u (H, hd) bf16, 16-byte aligned; s0 (B, H,
// hd, hd) float32; y (B, T, H, hd) bf16, s_out float32; B, T, H, hd;
// stream
extern "C" int rwkv6_scan_chunked_bf16(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* s0, void* y,
                                       void* s_out, int64_t n_b, int64_t n_t,
                                       int64_t n_h, int64_t hd, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_b * n_h == 0) return 0;
  if (n_t < 1) return cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return chunked<16>(r, k, v, w, u, s0, y, s_out, n_b, n_t, n_h, st);
    case 32:
      return chunked<32>(r, k, v, w, u, s0, y, s_out, n_b, n_t, n_h, st);
    case 64:
      return chunked<64>(r, k, v, w, u, s0, y, s_out, n_b, n_t, n_h, st);
    default:
      return cudaErrorInvalidValue;
  }
}
