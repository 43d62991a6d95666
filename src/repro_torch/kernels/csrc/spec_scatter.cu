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
// Three kinds of entry share these semantics.
//
// * The tensor entries (`spec_scatter_add_i32/f32`): device pointers,
//   one thread per (i, c), grid-stride.  The kernel API calls them.
// * The bf16 tensor entry (`spec_scatter_add_bf16`): the MoE buffer fill
//   (src/repro/models/moe.py, `_moe_spec_flat`), rows of d = 7168 bf16 at
//   Kimi-K2's width.  One block per request row (grid-stride over rows):
//   the block reads its index once, drops the row if it is poisoned, and
//   otherwise adds it with `atomicAdd` on `__nv_bfloat162` pairs where d
//   is even and both bases are 4-byte aligned, else on single
//   `__nv_bfloat16`s.  Each atomic rounds its sum to bf16, so duplicates
//   add up with a rounding per add, in an order that varies from run to
//   run; a destination that receives one request (the MoE fill, whose
//   slots are unique) gets 0 + v = v, bit for bit.
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
// row read-modify-write; 2-byte elements for bf16: at the MoE prefill's
// 32768 requests of 7168, about 0.94 GB, 0.28 ms at 3.35 TB/s).  On the codegen path d = 1 and n is at most a
// few thousand, so the launch and the PCIe reads bound the call, not the
// bytes.
#include <cstdint>
#include <cuda_bf16.h>
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

// bf16: row i of `values` added into row idx[i] of `table` (clipped),
// nothing for a poisoned idx[i]; `pairs` adds two elements per atomic.
__global__ void spec_scatter_add_rows_bf16_kernel(
    __nv_bfloat16* __restrict__ table, const int32_t* __restrict__ idx,
    const __nv_bfloat16* __restrict__ values, int64_t rows, int64_t n,
    int64_t d, bool pairs) {
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const int64_t r = idx[i];
    if (r < 0) continue;
    __nv_bfloat16* dst = table + (r < rows ? r : rows - 1) * d;
    const __nv_bfloat16* src = values + i * d;
    if (pairs) {
      auto* dst2 = reinterpret_cast<__nv_bfloat162*>(dst);
      const auto* src2 = reinterpret_cast<const __nv_bfloat162*>(src);
      for (int64_t c = threadIdx.x; c < d / 2; c += blockDim.x)
        atomicAdd(dst2 + c, src2[c]);
    } else {
      for (int64_t c = threadIdx.x; c < d; c += blockDim.x)
        atomicAdd(dst + c, src[c]);
    }
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

int launch_bf16(void* table, const void* idx, const void* values,
                int64_t rows, int64_t n, int64_t d, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(values);
  const bool pairs = d % 2 == 0 && bases % 4 == 0;
  const unsigned blocks = unsigned(n < kMaxBlocks ? n : kMaxBlocks);
  spec_scatter_add_rows_bf16_kernel<<<blocks, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(table), static_cast<const int32_t*>(idx),
      static_cast<const __nv_bfloat16*>(values), rows, n, d, pairs);
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

extern "C" int spec_scatter_add_bf16(void* table, const void* idx,
                                     const void* values, long long rows,
                                     long long n, long long d, void* stream) {
  return launch_bf16(table, idx, values, rows, n, d, stream);
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
