// scan.cuh: what the SSM scans' kernels share (rwkv6_scan.cu,
// mamba_scan.cu, rwkv6_chunk_sm90.cu, rwkv6_chunk_bwd_sm90.cu): cp.async,
// a warp reduce-scatter, and the column sums that reduce the chunked
// backward routes' partial sums.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

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

// bf16 bits as float32
__device__ __forceinline__ float bfu(uint16_t x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
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
__device__ __forceinline__ void reduce_level(float (&p)[V], int lane,
                                             unsigned mask) {
  const bool hi = lane & M;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const float send = sel(hi, p[q], p[q + M]);
    const float keep = sel(hi, p[q + M], p[q]);
    p[q] = keep + __shfl_xor_sync(mask, send, M);
  }
  if constexpr (M > 1) reduce_level<V, M / 2>(p, lane, mask);
}

// Sum V values p[0..V) over the lanes (of `mask`) that differ in the low
// log2(V) lane bits (a butterfly reduce-scatter): the result is the sum
// of index lane % V.  V - 1 shuffles.  Each level is its own instance,
// so every index is a constant and p stays in registers: written as a
// loop over halving widths, nvcc kept the arrays in local memory.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&p)[V], int lane,
                                                unsigned mask = 0xffffffffu) {
  reduce_level<V, V / 2>(p, lane, mask);
  return p[0];
}

// out[c] = sum over rows of in[row][c], the rows in order (so the sum is
// the same from run to run); a thread a column
__global__ void colsum_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int64_t rows,
                              int64_t cols) {
  const int64_t c = blockIdx.x * int64_t{blockDim.x} + threadIdx.x;
  if (c >= cols) return;
  float acc = 0.f;
  for (int64_t x = 0; x < rows; ++x) acc += in[x * cols + c];
  out[c] = acc;
}
