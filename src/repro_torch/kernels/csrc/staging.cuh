// Shared by the staged entries of spec_gather.cu and spec_scatter.cu: the
// codegen drivers' epoch round trip through page-locked, mapped host
// slots (src/repro_torch/kernels/staging.py).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace staging {

// Make `device` current for one entry call and put the caller's device back
// after it, so the Python side needs no device guard per call.
struct DeviceScope {
  int prev = -1;
  bool moved = false;
  int err = 0;
  explicit DeviceScope(int device) {
    err = int(cudaGetDevice(&prev));
    if (!err && prev != device) {
      err = int(cudaSetDevice(device));
      moved = err == 0;
    }
  }
  ~DeviceScope() {
    if (moved) cudaSetDevice(prev);
  }
};

// An entry's return: the error, after clearing the runtime's last-error
// state, so that a failed call (cudaHostGetFlags on pageable memory, say)
// is not reported again by the next launch's cudaGetLastError.
inline int done(int err) {
  if (err) cudaGetLastError();
  return err;
}

}  // namespace staging
