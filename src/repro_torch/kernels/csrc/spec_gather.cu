// spec_gather: speculative row gather with poison, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_spec_gather` in
// src/repro/kernels/spec_gather.py (body `_kernel`), which bursts one
// row DMA per request into VMEM and zeroes poisoned rows afterwards.
//
//   out[i, c] = idx[i] < 0 ? 0 : table[min(idx[i], rows - 1), c]
//
// A poisoned request issues no table load at all (the TPU kernel fetched
// a clamped row and masked it).  An index of at least `rows` clips to the
// last row, as the reference oracle does; the TPU kernel clamped only
// at 0.
//
// Three kinds of entry share these semantics.
//
// * The tensor entries (`spec_gather_i32/f32`): device pointers, one
//   thread per output element (i, c), grid-stride.  The kernel API
//   (`repro_torch.kernels.ops`) calls them.
// * The bf16 tensor entry (`spec_gather_bf16`): the MoE combine's gather
//   (src/repro/models/moe.py, `_moe_spec_flat`), rows of d = 7168 bf16 at
//   Kimi-K2's width.  One block per output row (grid-stride over rows):
//   the block reads its index once and copies the row as raw bytes, 16 at
//   a time where the row's byte width and both bases allow it, else 4 or
//   2; a poisoned row is written as zeros with no load.  The copy is
//   bitwise, so the gather is exact in any dtype of 2 bytes.
// * The staged entry (`spec_gather_staged_i32`): the codegen drivers'
//   epoch round trip on their int32 table of one-element rows.  Indices
//   sit in a page-locked, mapped host slot and the rows go back into
//   another; the kernel reads and writes host memory over PCIe directly,
//   and the entry waits for its stream before it returns, so one host
//   call takes a request from indices on the host to values on the host.
//   Like the TPU kernel's burst, the kernel gets the whole request in
//   flight before it uses any of it: each thread takes 4 indices in one
//   16-byte load and issues its 4 independent table loads before any
//   store, and a warp writes its 512 output bytes back as whole lines, so
//   a warp costs one PCIe round trip, not one per element.
//
// Bound: the call moves about n * (4 + 8 d) bytes (index, row read, row
// write; n * (4 + 4 d) for bf16).  At the MoE prefill's 32768 requests of
// 7168 bf16 that is 0.94 GB, 0.28 ms at 3.35 TB/s: the bf16 entry is
// byte-bound, and its 16-byte copies by whole rows are what it does about
// that.  On the codegen path d = 1 and n is at most a few thousand, so
// the bytes take nanoseconds at 3.35 TB/s; the launch, the PCIe round
// trip and the host's wait bound the call.
//
// `spec_staging_device_ptr` maps a page-locked host address to the
// address a kernel uses for it.  Two more entries exist only to measure
// the staged route against: `spec_staging_floor`, the latency floor (an
// empty kernel, or one 4-byte mapped read and write, launched and waited
// for the same way), and `spec_gather_copied_i32`, the same round trip
// through pinned cudaMemcpyAsync copies to and from device buffers
// instead of mapped reads and writes.
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

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

// Staged: the int32 table of the codegen drivers, rows of one element.
// Thread t takes indices 4t .. 4t+3.  `idx` and `out` are 16-byte aligned
// (the staging ring's buffers are); the last thread of a request whose n
// is not a multiple of 4 reads and writes element-wise.
__global__ void spec_gather_staged_kernel(const int32_t* __restrict__ table,
                                          const int32_t* __restrict__ idx,
                                          int32_t* __restrict__ out,
                                          int64_t rows, int64_t n) {
  const int64_t quads = (n + 3) / 4;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       t < quads; t += stride) {
    const int64_t base = 4 * t;
    const bool whole = base + 4 <= n;
    int32_t r[4];
    if (whole) {
      const int4 q = reinterpret_cast<const int4*>(idx)[t];
      r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = base + k < n ? idx[base + k] : -1;
    }
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = 0;
      if (r[k] >= 0) v[k] = table[r[k] < rows ? r[k] : rows - 1];
    }
    if (whole) {
      reinterpret_cast<int4*>(out)[t] = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (base + k < n) out[base + k] = v[k];
    }
  }
}

// bf16: row i of `out` is row idx[i] of `table` (clipped), or zeros for a
// poisoned idx[i]; rows are `w` words of type V (uint4, uint32_t or
// uint16_t), the widest that the row's bytes and both bases divide.
template <typename V>
__global__ void spec_gather_rows_kernel(const V* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        V* __restrict__ out, int64_t rows,
                                        int64_t n, int64_t w) {
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    const int64_t r = idx[i];
    V* dst = out + i * w;
    if (r < 0) {
      for (int64_t c = threadIdx.x; c < w; c += blockDim.x) dst[c] = V{};
    } else {
      const V* src = table + (r < rows ? r : rows - 1) * w;
      for (int64_t c = threadIdx.x; c < w; c += blockDim.x) dst[c] = src[c];
    }
  }
}

unsigned blocks_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  return unsigned(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

template <typename T>
int launch(const void* table, const void* idx, void* out, int64_t rows,
           int64_t n, int64_t d, void* stream) {
  spec_gather_kernel<T><<<blocks_for(n * d), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), rows, n, d);
  return int(cudaGetLastError());
}

template <typename V>
int launch_rows(const void* table, const void* idx, void* out, int64_t rows,
                int64_t n, int64_t row_bytes, void* stream) {
  const unsigned blocks = unsigned(n < kMaxBlocks ? n : kMaxBlocks);
  spec_gather_rows_kernel<V><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), rows, n, row_bytes / int64_t(sizeof(V)));
  return int(cudaGetLastError());
}

// The widest word that divides the row's bytes and both base addresses.
int gather_rows(const void* table, const void* idx, void* out, int64_t rows,
                int64_t n, int64_t row_bytes, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && bases % 16 == 0)
    return launch_rows<uint4>(table, idx, out, rows, n, row_bytes, stream);
  if (row_bytes % 4 == 0 && bases % 4 == 0)
    return launch_rows<uint32_t>(table, idx, out, rows, n, row_bytes,
                                 stream);
  return launch_rows<uint16_t>(table, idx, out, rows, n, row_bytes, stream);
}

int staged(const void* table, const void* idx, void* out, int64_t rows,
           int64_t n, void* stream, int device, int wait) {
  staging::DeviceScope scope(device);
  if (scope.err) return staging::done(scope.err);
  const auto s = static_cast<cudaStream_t>(stream);
  spec_gather_staged_kernel<<<blocks_for((n + 3) / 4), kThreads, 0, s>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), rows, n);
  int err = int(cudaGetLastError());
  if (!err && wait) err = int(cudaStreamSynchronize(s));
  return staging::done(err);
}

__global__ void spec_staging_floor_kernel(int32_t* p) {
  if (p != nullptr) p[0] += 1;
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

extern "C" int spec_gather_bf16(const void* table, const void* idx,
                                void* out, long long rows, long long n,
                                long long d, void* stream) {
  return gather_rows(table, idx, out, rows, n, 2 * d, stream);
}

// `idx` and `out` are mapped host addresses (spec_staging_device_ptr);
// with `wait` the call returns once the rows are in `out`.  `wait` = 0
// only launches, for capture in a CUDA graph.
extern "C" int spec_gather_staged_i32(const void* table, const void* idx,
                                      void* out, long long rows, long long n,
                                      void* stream, int device, int wait) {
  return staged(table, idx, out, rows, n, stream, device, wait);
}

// Refuses write-combined memory: the host reads the gathered rows back
// from the slot, and host reads of write-combined memory are uncached.
extern "C" int spec_staging_device_ptr(void* host, void** device_ptr) {
  unsigned int flags = 0;
  int err = int(cudaHostGetFlags(&flags, host));
  if (!err && (flags & cudaHostAllocWriteCombined))
    err = int(cudaErrorInvalidValue);
  if (!err) err = int(cudaHostGetDevicePointer(device_ptr, host, 0));
  return staging::done(err);
}

extern "C" int spec_gather_copied_i32(const void* table, const void* idx,
                                      void* out, void* idx_dev, void* out_dev,
                                      long long rows, long long n,
                                      void* stream, int device) {
  staging::DeviceScope scope(device);
  if (scope.err) return staging::done(scope.err);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = size_t(n) * sizeof(int32_t);
  int err = int(cudaMemcpyAsync(idx_dev, idx, bytes, cudaMemcpyHostToDevice,
                                s));
  if (!err) err = staged(table, idx_dev, out_dev, rows, n, stream, device, 0);
  if (!err)
    err = int(cudaMemcpyAsync(out, out_dev, bytes, cudaMemcpyDeviceToHost,
                              s));
  if (!err) err = int(cudaStreamSynchronize(s));
  return staging::done(err);
}

extern "C" int spec_staging_floor(void* mapped, void* stream, int device) {
  staging::DeviceScope scope(device);
  if (scope.err) return staging::done(scope.err);
  const auto s = static_cast<cudaStream_t>(stream);
  spec_staging_floor_kernel<<<1, 1, 0, s>>>(static_cast<int32_t*>(mapped));
  int err = int(cudaGetLastError());
  if (!err) err = int(cudaStreamSynchronize(s));
  return staging::done(err);
}
