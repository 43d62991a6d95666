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
// A poisoned request (idx < 0) is dropped and touches nothing.  Blocks
// run in no order on the card, so duplicate destinations meet through
// atomicAdd instead of a sort: for int32 the sum is exact in any order
// (two's-complement wrap, which the codegen drivers' delta trick relies
// on); for float32 the summation order, and so the last bits, vary from
// run to run.  The table is updated in place.
//
// Two entries share these semantics.
//
// * The tensor entries (`spec_scatter_add_i32/f32`): device pointers,
//   one thread per (i, c), grid-stride.  The kernel API calls them.
// * The staged entry (`spec_scatter_add_staged_i32`): the codegen
//   drivers' commit into their int32 table of one-element rows.  Indices
//   and values sit in a page-locked, mapped host slot, which the kernel
//   reads over PCIe directly.  The entry records the slot's event after
//   the launch and returns without waiting; the staging ring hands the
//   slot out again only once that event has completed.  Each thread
//   reads 4 indices and 4 values in one 16-byte load each, so a warp's
//   request arrives in one PCIe round trip, and issues its 4 atomics
//   after both loads.
//
// Bound: the call moves about n * (4 + 8 d) bytes (index, value read,
// row read-modify-write).  On the codegen path d = 1 and n is at most a
// few thousand, so the launch and the PCIe reads bound the call, not the
// bytes.
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

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

// Staged: the int32 table of the codegen drivers, rows of one element.
// Thread t takes requests 4t .. 4t+3 (`idx` and `values` 16-byte aligned,
// as the staging ring's buffers are; the last thread of a request whose n
// is not a multiple of 4 reads element-wise).
__global__ void spec_scatter_add_staged_kernel(
    int32_t* __restrict__ table, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ values, int64_t rows, int64_t n) {
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < quads; t += stride) {
    const int64_t base = 4 * t;
    int32_t r[4], v[4];
    if (base + 4 <= n) {
      const int4 q = reinterpret_cast<const int4*>(idx)[t];
      const int4 w = reinterpret_cast<const int4*>(values)[t];
      r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = base + k < n;
        r[k] = in ? idx[base + k] : -1;
        v[k] = in ? values[base + k] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (r[k] >= 0) atomicAdd(&table[r[k] < rows ? r[k] : rows - 1], v[k]);
  }
}

unsigned blocks_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  return unsigned(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename T>
int launch(void* table, const void* idx, const void* values, int64_t rows,
           int64_t n, int64_t d, void* stream) {
  spec_scatter_add_kernel<T><<<blocks_for(n * d), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(table), static_cast<const int32_t*>(idx),
      static_cast<const T*>(values), rows, n, d);
  return int(cudaGetLastError());
}

int staged(void* table, const void* idx, const void* values, int64_t rows,
           int64_t n, void* stream, void* event, int device) {
  staging::DeviceScope scope(device);
  if (scope.err) return staging::done(scope.err);
  const auto s = static_cast<cudaStream_t>(stream);
  spec_scatter_add_staged_kernel<<<blocks_for((n + 3) / 4), kThreads, 0, s>>>(
      static_cast<int32_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(values), rows, n);
  int err = int(cudaGetLastError());
  if (!err && event != nullptr)
    err = int(cudaEventRecord(static_cast<cudaEvent_t>(event), s));
  return staging::done(err);
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

// `idx` and `values` are mapped host addresses (spec_staging_device_ptr);
// `event` (null for capture in a CUDA graph) is recorded on the stream
// after the launch, and the call returns without waiting.
extern "C" int spec_scatter_add_staged_i32(void* table, const void* idx,
                                           const void* values, long long rows,
                                           long long n, void* stream,
                                           void* event, int device) {
  return staged(table, idx, values, rows, n, stream, event, device);
}
