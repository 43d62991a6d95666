// rwkv6_chunk.cuh: what the RWKV-6 chunked kernels share (the forward,
// rwkv6_chunk_sm90.cu, and the backward, rwkv6_chunk_bwd_sm90.cu), for
// both activation types (float32 and bf16): staging, TF32 helpers, and the
// scores of a chunk's own tokens.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {


using bf16 = __nv_bfloat16;
constexpr int kC = 16;         // tokens a chunk

// row pitch of a staged chunk tile of T, in elements: rows stay 16-byte
// aligned, and the B-operand fragments (rows q, columns g) fall in
// distinct banks for float32 (72 = 8 mod 32 words)
template <int HD>
constexpr int kPitch = HD + 8;

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

// d += a b and e += the small terms over one m16n8k8 step, a float32 A as
// a hi + lo pair of tf32 operands and B as activations (b0 and b1 its
// fragment's two values): a bf16 b is exact in tf32, so two products (lo
// b into e, hi b into d); a float32 b is a pair too, and its products
// are three (lo b_hi and hi b_lo into e, hi b_hi into d), about 2**-20
// of float32 where one tf32 product keeps 2**-11.  d and e may be one
// array.
__device__ __forceinline__ void mma_split(float (&d)[4], float (&e)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], bf16 b0,
                                          bf16 b1) {
  mma_tf32(e, lo, bf_bits(b0), bf_bits(b1));
  mma_tf32(d, hi, bf_bits(b0), bf_bits(b1));
}

__device__ __forceinline__ void mma_split(float (&d)[4], float (&e)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], float b0,
                                          float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(e, lo, h0, h1);
  mma_tf32(e, hi, l0, l1);
  mma_tf32(d, hi, h0, h1);
}

// N channels of one staged row of T as float32
template <int N, typename T>
__device__ __forceinline__ void ld_row(float (&out)[N], const T* p) {
  if constexpr (N == 1) {
    out[0] = to_f(p[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int x = 0; x < N; x += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + x);
      out[x] = f.x;
      out[x + 1] = f.y;
    }
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

// two adjacent outputs rounded to T, one store
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The scores of a chunk's own tokens in float32, into sc[t][s] (t the
// query, s < t the key; the diagonal is the bonus):
//   sc[t][s] = sum_i r_t[i] k_s[i] prod_{s < tau < t} w_tau[i]
//   sc[t][t] = sum_i r_t[i] u[i] k_t[i]
// Called by 128 threads (four whole warps): thread (tq, group of HD/16
// channels) takes tokens tq and 15 - tq (15 key steps in all), walking s
// down from t - 1 so each step multiplies its decay by one w; the channel
// groups meet in a butterfly reduce-scatter of warp shuffles.  Entries
// above the diagonal are left as they were or written 0.
template <int HD, int P, typename T>
__device__ __forceinline__ void chunk_scores(const T (*in_r)[P],
                                             const T (*in_k)[P],
                                             const T (*in_w)[P],
                                             const float* u,
                                             float (*sc)[kC + 4], int tid) {
  constexpr int kCH = HD / 16;  // channels a thread
  const int lane = tid & 31;
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
    const float ui = u[i0 + x];
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
  // the lane of its column (a register array indexed by ta or tb would
  // live in local memory)
#pragma unroll
  for (int m = kC / 2; m >= 1; m /= 2) {
    bonus_a += __shfl_xor_sync(0xffffffffu, bonus_a, m);
    bonus_b += __shfl_xor_sync(0xffffffffu, bonus_b, m);
  }
  sc[tb][cg] = cg == tb ? sb + bonus_b : sb;
  sc[ta][cg] = cg == ta ? sa + bonus_a : cg < kC / 2 ? sa : 0.f;
}

}  // namespace
