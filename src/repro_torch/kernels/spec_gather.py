"""spec_gather — speculative row gather with poison (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_spec_gather`` of the JAX package's
``kernels/spec_gather.py``.  The CUDA source is ``csrc/spec_gather.cu``.
Two routes, chosen by the caller's entry point, never by a switch:

* ``"tensor"`` — :func:`spec_gather`, the kernel API and the MoE
  combine: a device index tensor in, a device tensor out.  int32 and
  float32 take one thread per output element; bfloat16 (the MoE
  dispatch's rows) one block per output row, copied in 16-byte words
  where the row allows.  A poisoned row issues no load.
* ``"staged"`` — :func:`spec_gather_staged`, the codegen drivers' epoch
  round trip on their int32 table of one-element rows: indices in a slot
  of a :class:`~repro_torch.kernels.staging.Ring`, values back in the
  same slot.  On CUDA the slot is page-locked, mapped host memory that
  the kernel reads and writes over PCIe, and the one C call returns once
  the values are there: one host call and one crossing each way a
  request, every load of the request in flight at once.

Per call the kernel moves about ``n * (4 + 8 d)`` bytes; at the codegen
path's epoch sizes (``d = 1``, at most a few thousand rows) that is
nanoseconds at 3.35 TB/s, so launch latency and the round trip bound it.
``spec_gather.launches`` counts both routes' launches,
``spec_gather.route_launches`` each route's, and
``spec_gather.entry_launches`` each C entry's (``spec_gather_bf16`` is
the MoE path's).

``block_n`` / ``block_d`` were TPU tiling and are not taken here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..resilience import faults
from . import ref
from .build import check, load
from .dispatch import (check_table_idx, on_cuda, refuse_grad, stream_of,
                       suffix)
from .staging import Slot, check_staged

ROUTES = ("tensor", "staged")


def spec_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather ``table[idx]`` with poisoned (negative) indices zeroed.

    ``table`` is ``(rows, d)`` int32, float32 or bfloat16, ``idx`` is ``(n,)``
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
    refuse_grad("spec_gather", table)
    if faults.ACTIVE and faults.fire("kernels.gather.allpoison"):
        idx = torch.full_like(idx, -1)
    if not cuda:
        out = ref.spec_gather(table, idx)
    else:
        n, d = idx.shape[0], table.shape[1]
        out = torch.empty((n, d), dtype=table.dtype, device=table.device)
        if n and d:
            entry = f"spec_gather_{suffix(table.dtype)}"
            with torch.cuda.device(table.device):
                err = getattr(load("spec_gather"), entry)(
                    table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    table.shape[0], n, d, stream_of(table))
            check(err, "spec_gather")
            spec_gather.launches += 1
            spec_gather.route_launches["tensor"] += 1
            spec_gather.entry_launches[entry] += 1
    if faults.ACTIVE and faults.fire("kernels.gather.rows"):
        out[::2] += 1
    return out


@functools.cache
def _staged_entry():
    """The staged C entry, bound once."""
    return load("spec_gather").spec_gather_staged_i32


def spec_gather_staged(table: torch.Tensor, slot: Slot,
                       n: int) -> np.ndarray:
    """Gather the rows of ``table`` at the first ``n`` indices of ``slot``.

    ``table`` is the codegen drivers' contiguous ``(rows, 1)`` int32
    table.  Returns the ``n`` gathered values as a numpy view of the
    slot's output buffer, valid until the slot is handed out again; the
    semantics are :func:`spec_gather`'s.  On a CUDA table the staged kernel
    launches and the call returns once the values are in the slot; on a
    CPU table the plain version runs on the slot's indices.  The fault
    sites fire where :func:`spec_gather`'s do: ``kernels.gather.allpoison``
    overwrites the slot's indices with ``-1`` before the kernel,
    ``kernels.gather.rows`` corrupts alternate output rows after it.
    """
    check_staged(table, slot, n)
    idx = slot.idx[:n]
    out = slot.out[:n]
    if faults.ACTIVE and faults.fire("kernels.gather.allpoison"):
        idx[:] = -1
    if slot.out_ptr is None:
        out[:] = ref.spec_gather(table, torch.from_numpy(idx))[:, 0].numpy()
    elif n:
        err = _staged_entry()(table.data_ptr(), slot.idx_ptr, slot.out_ptr,
                              len(table), n, slot.stream, slot.device, 1)
        check(err, "spec_gather")
        spec_gather.launches += 1
        spec_gather.route_launches["staged"] += 1
        spec_gather.entry_launches["spec_gather_staged_i32"] += 1
    if faults.ACTIVE and faults.fire("kernels.gather.rows"):
        out[::2] += 1
    return out


#: kernel launches since the count was last set to 0, both routes
spec_gather.launches = 0
#: the same launches by route
spec_gather.route_launches = dict.fromkeys(ROUTES, 0)
#: the same launches by C entry
spec_gather.entry_launches = dict.fromkeys(
    ("spec_gather_i32", "spec_gather_f32", "spec_gather_bf16",
     "spec_gather_staged_i32"), 0)
