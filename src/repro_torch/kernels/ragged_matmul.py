"""ragged_matmul — grouped expert GEMM (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_ragged_matmul`` of the JAX package's
``kernels/ragged_matmul.py``.  Two hand-written kernels, chosen by
:func:`plan` from the dtype and the shapes TMA can describe:

* ``"tma"`` — bfloat16 with D and F multiples of 8 and all three tensors
  16-byte aligned: ``csrc/ragged_matmul_sm90.cu``.  A persistent grid (one
  block per SM) walks the output tiles, 64 rows of one expert by
  ``block_n`` columns, the F tiles of one expert side by side; a producer
  warp keeps a four-stage TMA ring of 64x64 ``x`` and 64x``block_n``
  ``w`` tiles in flight (3-D maps over (E, capacity, D) and (E, D, F), so
  rows past ``capacity`` read zeros); one warpgroup runs ``wgmma`` with
  f32 accumulators and stores bfloat16 in 16-byte writes.
* ``"tiled"`` — float32, or bfloat16 whose row strides (D or F not a
  multiple of 8) or base addresses TMA cannot take:
  ``csrc/ragged_matmul.cu``, one block per output tile of one expert, K
  looped inside the block (bfloat16 on the tensor cores through
  ``wmma``, float32 on the CUDA cores in full float32).

Both sum in float32 and write the output in ``x``'s dtype, mask every
ragged edge (``capacity`` need not be a multiple of the tile) and use
64-bit offsets (at Kimi-K2's expert FFN ``w`` has 5.6e9 elements).
Reading ``w`` once bounds the call at that width.  A CUDA tensor always
takes one of the two kernels; a failed build or launch raises.

``bm`` / ``bn`` / ``bk`` / ``interpret`` were TPU tiling and Pallas mode
and are not taken here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import ref
from .build import check, load
from .dispatch import (aligned16, check_float, on_cuda, refuse_grad,
                       stream_of, suffix)

#: rows and K of one TMA-route tile (its TMA boxes are 64 elements, the
#: 128-byte swizzle's width, by 64 rows)
BLOCK_M = BLOCK_K = 64
ROUTES = ("tma", "tiled")


class Plan(NamedTuple):
    """Which kernel takes a call, and the tile width and grid passed to it
    (0 on the tiled route, whose kernel fixes its own)."""

    route: str
    block_n: int
    #: blocks launched: persistent, at most one per SM
    grid: int


def plan(e: int, capacity: int, d: int, f: int, dtype: torch.dtype,
         aligned: bool, sm_count: int) -> Plan:
    """The route of a checked call with ``x`` (E*capacity, D) and ``w``
    (E, D, F): ``"tma"`` for bfloat16 with D and F multiples of 8 and
    every tensor 16-byte aligned (``aligned``), else ``"tiled"``."""
    if dtype == torch.bfloat16 and aligned and d % 8 == 0 and f % 8 == 0 \
            and d > 0:
        block_n = 256 if f > 128 else 128
        tiles = e * -(-capacity // BLOCK_M) * -(-f // block_n)
        return Plan("tma", block_n, min(tiles, sm_count))
    return Plan("tiled", 0, 0)


def ragged_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  capacity: int) -> torch.Tensor:
    """``x`` (E*capacity, D) expert-contiguous times ``w`` (E, D, F).

    Row ``r`` uses expert ``r // capacity``; the sums are float32 and the
    output (E*capacity, F) is in ``x``'s dtype (float32 or bfloat16, the
    same for both inputs).  On CUDA tensors a kernel launches — the route
    of :func:`plan` — and ``ragged_matmul.launches`` counts it
    (``ragged_matmul.route_launches`` by route); on CPU tensors the plain
    version in :mod:`repro_torch.kernels.ref` runs.
    """
    cuda = on_cuda(x, w)
    check_float("ragged_matmul", x, w)
    refuse_grad("ragged_matmul", x, w)
    if w.dim() != 3:
        raise ValueError(f"w must be (E, D, F), got {tuple(w.shape)}")
    e, d, f = w.shape
    if capacity < 1:
        raise ValueError(f"capacity must be positive, got {capacity}")
    if tuple(x.shape) != (e * capacity, d):
        raise ValueError(f"x shape {tuple(x.shape)} != (E*capacity, D) = "
                         f"{(e * capacity, d)}")
    if not cuda:
        return ref.ragged_matmul(x, w, capacity)
    out = torch.empty((e * capacity, f), dtype=x.dtype, device=x.device)
    if out.numel():
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        p = plan(e, capacity, d, f, x.dtype,
                 all(aligned16(t) for t in (x, w, out)), sms)
        with torch.cuda.device(x.device):
            if p.route == "tma":
                fn = load("ragged_matmul_sm90").ragged_matmul_sm90_bf16
                err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e,
                         capacity, d, f, p.block_n, p.grid, stream_of(x))
            else:
                fn = getattr(load("ragged_matmul"),
                             f"ragged_matmul_{suffix(x.dtype)}")
                err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e,
                         capacity, d, f, stream_of(x))
        check(err, f"ragged_matmul ({p.route})")
        ragged_matmul.launches += 1
        ragged_matmul.route_launches[p.route] += 1
    return out


#: kernel launches since the count was last set to 0
ragged_matmul.launches = 0
#: the same launches by route (:data:`ROUTES`)
ragged_matmul.route_launches = dict.fromkeys(ROUTES, 0)
