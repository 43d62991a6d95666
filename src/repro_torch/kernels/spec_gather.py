"""spec_gather — speculative row gather with poison (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_spec_gather`` of the JAX package's
``kernels/spec_gather.py``.  The CUDA source is ``csrc/spec_gather.cu``:
one thread per output element, a poisoned row issues no load.  Per call
the kernel moves about ``n * (4 + 8 d)`` bytes; at the codegen path's
epoch sizes (``d = 1``, at most a few thousand rows) that is nanoseconds
at 3.35 TB/s, so launch latency bounds it.

``block_n`` / ``block_d`` were TPU tiling and are not taken here.
"""
from __future__ import annotations

import torch

from ..resilience import faults
from . import ref
from .build import check, load
from .dispatch import check_table_idx, on_cuda, stream_of


def spec_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``table[idx]`` with poisoned (negative) indices zeroed.

    ``table`` is ``(rows, d)`` int32 or float32, ``idx`` is ``(n,)``
    int32; an index of at least ``rows`` clips to the last row.  On CUDA
    tensors the kernel launches (and ``spec_gather.launches`` counts it);
    on CPU tensors the plain version in :mod:`repro_torch.kernels.ref`
    runs.

    Fault sites (active only under an armed
    :class:`~repro_torch.resilience.faults.FaultPlan`):
    ``kernels.gather.allpoison`` poisons the whole request batch before
    the kernel, ``kernels.gather.rows`` corrupts alternate output rows
    after it — the same places as in the reference.
    """
    cuda = on_cuda(table, idx)
    check_table_idx(table, idx)
    if faults.ACTIVE and faults.fire("kernels.gather.allpoison"):
        idx = torch.full_like(idx, -1)
    if not cuda:
        out = ref.spec_gather(table, idx)
    else:
        n, d = idx.shape[0], table.shape[1]
        out = torch.empty((n, d), dtype=table.dtype, device=table.device)
        if n and d:
            fn = (load("spec_gather").spec_gather_i32
                  if table.dtype == torch.int32
                  else load("spec_gather").spec_gather_f32)
            with torch.cuda.device(table.device):
                err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         table.shape[0], n, d, stream_of(table))
            check(err, "spec_gather")
            spec_gather.launches += 1
    if faults.ACTIVE and faults.fire("kernels.gather.rows"):
        out[::2] += 1
    return out


#: kernel launches since the count was last set to 0
spec_gather.launches = 0
