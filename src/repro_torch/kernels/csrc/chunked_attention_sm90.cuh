// chunked_attention_sm90.cuh: what the Hopper (sm_90a) chunked-attention
// sources share: chunked_attention_sm90.cu (the tile and split forwards)
// and chunked_attention_bwd_sm90.cu (the tile backward), built as two
// libraries so that nvcc compiles them side by side.
//
// The function is chunked_attention.cu's:
//
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] / sqrt(d)) v[b,h,j]
//
// over the keys j < tk, and j <= q_offset + i when causal (top-left
// alignment, shifted by q_offset).  q, k, v are contiguous bf16 (B*H, T,
// d), 16-byte aligned.  Every row has a live key (tk >= 1, q_offset >= 0).
// Scores, softmax state and sums are float32; p and dS are rounded to bf16
// for their products (as chunked_attention.cu rounds them); exponentials
// are ex2.approx with scale * log2(e) folded in.
//
// Head widths (d 64, 112, 128, 160 on the tile routes).  Shared memory
// holds whole 128-byte-swizzled chunks of 64 columns, ceil(d / 64) of them
// (a padded width of 128 at d 112, 192 at d 160); the tensor maps keep the
// true d as the row length, so a box past column d reads zeros and moves
// nothing from device memory: the byte bound does not grow.  The products
// run at the true width: Q K^T over d / 16 k-steps (7 at d 112, 10 at d
// 160), P V, dQ and dK / dV with N = d (wgmma takes any N that is a
// multiple of 8 up to 256), so no zero column is multiplied or stored, and
// outputs are written at row pitch d.  The softmax scale is 1 / sqrt(d).
//
// A condition these products rest on: at d 112 and 160 the MN-major B
// operand of P V, dQ and dK / dV ends inside a swizzled 64-column chunk
// (48 of 64 columns at d 112, 32 at d 160), and wgmma must read its first
// N columns there under the same swizzle as a whole chunk.  The PTX
// documentation does not state this for a partial chunk.  The card tests
// (tests/test_torch_cuda.py, the d-112 and d-160 tile cases against the
// float32 loop) and chip_smoke.py's [attn] phase check it on every
// build; if it ever fails, pad N to the padded width (128 or 192) and keep
// the stores at columns < d.
#pragma once

#include <math_constants.h>

#include "hopper.cuh"

namespace attn_sm90 {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// O (64 x N) += P (64 x 16, registers) * B (16 x N, smem, MN-major)
template <int N>
__device__ __forceinline__ void rs_product(float (&o)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  static_assert(N == 64 || N == 112 || N == 128 || N == 160, "wgmma N");
  if constexpr (N == 64)
    wgmma_rs_m64n64<1>(o, a, b, 1);
  else if constexpr (N == 112)
    wgmma_rs_m64n112<1>(o, a, b, 1);
  else if constexpr (N == 128)
    wgmma_rs_m64n128<1>(o, a, b, 1);
  else
    wgmma_rs_m64n160<1>(o, a, b, 1);
}

// 64-column chunks of a row of d columns, the last one padded
__host__ __device__ constexpr int chunks_of(int d) { return (d + 63) / 64; }

// S (64 x N) (+)= A (64 x 16, smem) * B (16 x N, smem, K-major)
template <int N>
__device__ __forceinline__ void ss_product(float (&s)[N / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma N");
  if constexpr (N == 32)
    wgmma_ss_m64n32<0>(s, a, b, scale_d);
  else if constexpr (N == 64)
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

// Shared memory descriptors of a 128-byte-swizzled tile stored as
// chunks_of(D) chunks of `chunk` bytes: the K-major operand at k-step kk
// (16 columns), and the MN-major one at k-step kk (16 rows; at N = 112 or
// 160 wgmma reads the last chunk in part: see the head of this file).
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk,
                                           uint32_t chunk) {
  return sw128_desc(base + (kk / 4) * chunk + (kk % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk,
                                            uint32_t chunk) {
  return sw128_desc(base + kk * 2048, chunk, 1024);
}

// the tile kernels' blocks: a producer and two consumer warpgroups
constexpr int kTileThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;

__device__ __forceinline__ void bf16x8(float (&f)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

inline bool shapes_ok(int64_t bh, int64_t tq, int64_t tk, int64_t q_offset) {
  return bh >= 1 && tq >= 1 && tk >= 1 && q_offset >= 0 &&
         tq <= 0x7fffff00LL && tk <= 0x7fffff00LL && bh <= 0x7fffffffLL;
}

// q_offset as the kernels take it: past tk - 1 every key is live, so
// larger offsets clamp there (and fit an int)
inline int clamp_offset(int64_t tk, int64_t q_offset) {
  return int(q_offset < tk ? q_offset : tk);
}

}  // namespace attn_sm90
