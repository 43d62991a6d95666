// attn_mma.cuh: the mma.sync building blocks of the bf16 chunked-attention
// bodies (chunked_attention.cu, chunked_attention_head.cu).
//
// - ldmatrix fragment loads from row-major bf16 tiles in shared memory
//   (row stride LD elements, rows 16-byte aligned), .trans for the operand
//   stored k-major;
// - m16n8k16 products with bf16 operands and float32 accumulators;
// - two float32 accumulator n-tiles repacked as the next product's A
//   operand (rounded to bf16), and the ex2 the softmax bodies take.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace attn_mma {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4],
                                      const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// D += A B: m16n8k16, A row-major (16 x 16), B column-major (16 x 8),
// bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand (16 x 16) at rows r0, columns c0 of a row-major tile
// (row stride LD): a[0] rows 0-7 / cols 0-7, a[1] rows 8-15 / cols 0-7,
// a[2] rows 0-7 / cols 8-15, a[3] rows 8-15 / cols 8-15.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int r0, int c0,
                                       int lane) {
  const int mi = lane >> 3;
  ldsm4(a, s + (r0 + (lane & 7) + (mi & 1) * 8) * LD + c0 + (mi >> 1) * 8);
}

// The B operands of two n-tiles, B(k, n) = s[n][k] (keys stored as rows,
// as K for Q K^T): n0..n0+15, k0..k0+15.  b[0], b[1] are n-tile n0's,
// b[2], b[3] n-tile n0 + 8's.
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* s, int n0,
                                          int k0, int lane) {
  const int mi = lane >> 3;
  ldsm4(b, s + (n0 + (lane & 7) + (mi >> 1) * 8) * LD + k0 + (mi & 1) * 8);
}

// The same for B(k, n) = s[k][n] (as V for P V): ldmatrix .trans.
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* s, int k0,
                                          int n0, int lane) {
  const int mi = lane >> 3;
  ldsm4_t(b, s + (k0 + (lane & 7) + (mi & 1) * 8) * LD + n0 + (mi >> 1) * 8);
}

// Two float32 accumulator n-tiles (rows 16, columns 16) as one A operand
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c0)[4],
                                     const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

}  // namespace attn_mma
