"""spec_scatter — poison-masked scatter-add (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_spec_scatter_add`` of the JAX package's
``kernels/spec_scatter.py``.  The CUDA source is ``csrc/spec_scatter.cu``:
one thread per element, ``atomicAdd`` in place of the TPU kernel's
destination sort, a poisoned request touches nothing.  Per call the
kernel moves about ``n * (4 + 8 d)`` bytes; at the codegen path's epoch
sizes launch latency bounds it.

int32 sums are exact in any order; float32 sums meet in an order that
varies from run to run, so float results agree with the plain version
to rounding only (the tests hold them to ``atol=1e-4``, the JAX
package's float32 scatter tolerance).
"""
from __future__ import annotations

import torch

from ..resilience import faults
from . import ref
from .build import check, load
from .dispatch import check_table_idx, on_cuda, stream_of


def spec_scatter_add(table: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """Add ``values`` into ``table`` at ``idx``, poisoned rows dropped.

    Updates ``table`` **in place** and returns it (the reference returned
    a new array; every caller here owns its table and reassigns it).
    ``values`` is ``(n, d)`` of ``table``'s dtype; duplicate indices add
    up; an index of at least ``rows`` clips to the last row.  On CUDA
    tensors the kernel launches (and ``spec_scatter_add.launches``
    counts it); on CPU tensors the plain version runs.

    Fault sites: ``kernels.scatter.raise`` raises before the kernel;
    ``kernels.scatter.allpoison`` silently drops the whole batch — the
    same places as in the reference.
    """
    cuda = on_cuda(table, idx, values)
    check_table_idx(table, idx)
    if values.dtype != table.dtype:
        raise TypeError(f"values dtype {values.dtype} != table dtype "
                        f"{table.dtype}")
    if tuple(values.shape) != (idx.shape[0], table.shape[1]):
        raise ValueError(f"values shape {tuple(values.shape)} != "
                         f"{(idx.shape[0], table.shape[1])}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if faults.ACTIVE:
        faults.inject("kernels.scatter.raise")
        if faults.fire("kernels.scatter.allpoison"):
            idx = torch.full_like(idx, -1)
    if not cuda:
        return ref.spec_scatter_add(table, idx, values)
    n, d = idx.shape[0], table.shape[1]
    if n and d:
        fn = (load("spec_scatter").spec_scatter_add_i32
              if table.dtype == torch.int32
              else load("spec_scatter").spec_scatter_add_f32)
        with torch.cuda.device(table.device):
            err = fn(table.data_ptr(), idx.data_ptr(), values.data_ptr(),
                     table.shape[0], n, d, stream_of(table))
        check(err, "spec_scatter_add")
        spec_scatter_add.launches += 1
    return table


#: kernel launches since the count was last set to 0
spec_scatter_add.launches = 0
