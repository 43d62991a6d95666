// spec_scatter_add: poison-masked scatter-add, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_spec_scatter_add` in
// src/repro/kernels/spec_scatter.py (body `_kernel`), which sorts the
// requests by destination and runs one read-add-write per request through
// a VMEM row buffer, in order, on the TPU's sequential grid.
//
//   for every i with idx[i] >= 0:
//     table[min(idx[i], rows - 1), c] += values[i, c]
//
// One thread per (i, c), grid-stride; a poisoned request (idx < 0) is
// dropped and touches nothing.  Blocks run in no order on the card, so
// duplicate destinations meet through atomicAdd instead of a sort: for
// int32 the sum is exact in any order (two's-complement wrap, which the
// codegen drivers' delta trick relies on); for float32 the summation
// order, and so the last bits, vary from run to run.  The table is
// updated in place.
//
// Bound: the call moves about n * (4 + 8 d) bytes (index, value read,
// row read-modify-write).  On the codegen path d = 1 and n is at most a
// few thousand, so the launch latency bounds the call, not the bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

template <typename T>
__global__ void spec_scatter_add_kernel(T* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        const T* __restrict__ values,
                                        int64_t rows, int64_t n, int64_t d) {
  const int64_t total = n * d;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / d;
    const int64_t r = idx[i];
    if (r < 0) continue;
    const int64_t c = t - i * d;
    atomicAdd(&table[(r < rows ? r : rows - 1) * d + c], values[t]);
  }
}

template <typename T>
int launch(void* table, const void* idx, const void* values, int64_t rows,
           int64_t n, int64_t d, void* stream) {
  const int64_t total = n * d;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  spec_scatter_add_kernel<T><<<unsigned(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const T*>(values), rows, n, d);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int spec_scatter_add_i32(void* table, const void* idx,
                                    const void* values, long long rows,
                                    long long n, long long d, void* stream) {
  return launch<int>(table, idx, values, rows, n, d, stream);
}

extern "C" int spec_scatter_add_f32(void* table, const void* idx,
                                    const void* values, long long rows,
                                    long long n, long long d, void* stream) {
  return launch<float>(table, idx, values, rows, n, d, stream);
}
