// spec_gather: speculative row gather with poison, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_spec_gather` in
// src/repro/kernels/spec_gather.py (body `_kernel`), which bursts one
// row DMA per request into VMEM and zeroes poisoned rows afterwards.
//
//   out[i, c] = idx[i] < 0 ? 0 : table[min(idx[i], rows - 1), c]
//
// One thread per output element (i, c), grid-stride.  A poisoned request
// issues no table load at all (the TPU kernel fetched a clamped row and
// masked it).  An index of at least `rows` clips to the last row, as the
// reference oracle does; the TPU kernel clamped only at 0.
//
// Bound: the call moves about n * (4 + 8 d) bytes (index, row read, row
// write).  On the codegen path d = 1 and n is at most a few thousand, so
// the bytes take nanoseconds at 3.35 TB/s and the launch latency bounds
// the call; the design keeps the kernel to one launch with no shared
// memory and no second pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 16;

template <typename T>
__global__ void spec_gather_kernel(const T* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t rows,
                                   int64_t n, int64_t d) {
  const int64_t total = n * d;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / d;
    const int64_t c = t - i * d;
    const int64_t r = idx[i];
    T v = T(0);
    if (r >= 0) v = table[(r < rows ? r : rows - 1) * d + c];
    out[t] = v;
  }
}

template <typename T>
int launch(const void* table, const void* idx, void* out, int64_t rows,
           int64_t n, int64_t d, void* stream) {
  const int64_t total = n * d;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  spec_gather_kernel<T><<<unsigned(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), rows, n, d);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int spec_gather_i32(const void* table, const void* idx, void* out,
                               long long rows, long long n, long long d,
                               void* stream) {
  return launch<int32_t>(table, idx, out, rows, n, d, stream);
}

extern "C" int spec_gather_f32(const void* table, const void* idx, void* out,
                               long long rows, long long n, long long d,
                               void* stream) {
  return launch<float>(table, idx, out, rows, n, d, stream);
}
