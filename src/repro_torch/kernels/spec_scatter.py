"""spec_scatter — poison-masked scatter-add (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_spec_scatter_add`` of the JAX package's
``kernels/spec_scatter.py``.  The CUDA source is ``csrc/spec_scatter.cu``:
``atomicAdd`` in place of the TPU kernel's destination sort, a poisoned
request touches nothing.  Two routes, chosen by the caller's entry point,
never by a switch:

* ``"tensor"`` — :func:`spec_scatter_add`, the kernel API and the MoE
  buffer fill: device index and value tensors.  int32 and float32 take
  one thread per element; bfloat16 (the MoE dispatch's rows) one block
  per request row, ``atomicAdd`` on ``__nv_bfloat162`` pairs where the
  row width is even.
* ``"staged"`` — :func:`spec_scatter_add_staged`, the codegen drivers'
  commit into their int32 table of one-element rows: indices and values
  in a slot of a :class:`~repro_torch.kernels.staging.Ring`.  On CUDA
  the kernel reads the page-locked, mapped slot over PCIe; the one C
  call records the slot's event and returns without waiting, and the
  ring waits for that event before it hands the slot out again.

Per call the kernel moves about ``n * (4 + 8 d)`` bytes; at the codegen
path's epoch sizes launch latency bounds it.
``spec_scatter_add.launches`` counts both routes' launches,
``spec_scatter_add.route_launches`` each route's, and
``spec_scatter_add.entry_launches`` each C entry's
(``spec_scatter_add_bf16`` is the MoE path's).

int32 sums are exact in any order; float32 sums meet in an order that
varies from run to run, so float results agree with the plain version
to rounding only (the tests hold them to ``atol=1e-4``, the JAX
package's float32 scatter tolerance).  bfloat16 rounds at every add: a
destination that receives one request is exact (``0 + v``, the MoE
fill's unique slots), duplicates are held to the float32 sum within
:func:`~repro_torch.kernels.ref.bf16_sum_bound`.
"""
from __future__ import annotations

import functools

import torch

from ..resilience import faults
from . import ref
from .build import check, load
from .dispatch import check_table_idx, on_cuda, stream_of, suffix
from .staging import Slot, check_staged

ROUTES = ("tensor", "staged")


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
        entry = f"spec_scatter_add_{suffix(table.dtype)}"
        with torch.cuda.device(table.device):
            err = getattr(load("spec_scatter"), entry)(
                table.data_ptr(), idx.data_ptr(), values.data_ptr(),
                table.shape[0], n, d, stream_of(table))
        check(err, "spec_scatter_add")
        spec_scatter_add.launches += 1
        spec_scatter_add.route_launches["tensor"] += 1
        spec_scatter_add.entry_launches[entry] += 1
    return table


@functools.cache
def _staged_entry():
    """The staged C entry, bound once."""
    return load("spec_scatter").spec_scatter_add_staged_i32


def spec_scatter_add_staged(table: torch.Tensor, slot: Slot,
                            n: int) -> torch.Tensor:
    """Add the first ``n`` values of ``slot`` into ``table`` at its first
    ``n`` indices, in place; returns ``table``.

    ``table`` is the codegen drivers' contiguous ``(rows, 1)`` int32
    table; the semantics are :func:`spec_scatter_add`'s.  On a CUDA table
    the staged kernel launches and the call returns without waiting (the
    slot stays pending until its event completes); on a CPU table the
    plain version runs on the slot's arrays.  Fault sites fire where
    :func:`spec_scatter_add`'s do: ``kernels.scatter.raise`` raises before
    the kernel, ``kernels.scatter.allpoison`` overwrites the slot's
    indices with ``-1``.
    """
    check_staged(table, slot, n)
    idx = slot.idx[:n]
    if faults.ACTIVE:
        faults.inject("kernels.scatter.raise")
        if faults.fire("kernels.scatter.allpoison"):
            idx[:] = -1
    if slot.val_ptr is None:
        ref.spec_scatter_add(table, torch.from_numpy(idx),
                             torch.from_numpy(slot.val[:n])[:, None])
        slot.launched()
    elif n:
        err = _staged_entry()(table.data_ptr(), slot.idx_ptr, slot.val_ptr,
                              len(table), n, slot.stream, slot.event_ptr,
                              slot.device)
        check(err, "spec_scatter_add")
        slot.launched()
        spec_scatter_add.launches += 1
        spec_scatter_add.route_launches["staged"] += 1
        spec_scatter_add.entry_launches["spec_scatter_add_staged_i32"] += 1
    return table


#: kernel launches since the count was last set to 0, both routes
spec_scatter_add.launches = 0
#: the same launches by route
spec_scatter_add.route_launches = dict.fromkeys(ROUTES, 0)
#: the same launches by C entry
spec_scatter_add.entry_launches = dict.fromkeys(
    ("spec_scatter_add_i32", "spec_scatter_add_f32", "spec_scatter_add_bf16",
     "spec_scatter_add_staged_i32"), 0)
