"""ragged_matmul — grouped expert GEMM (CUDA, sm_90a).

Replaces the Pallas TPU kernel ``_ragged_matmul`` of the JAX package's
``kernels/ragged_matmul.py``.  The CUDA source is
``csrc/ragged_matmul.cu``: one block per output tile of one expert, K in
a loop inside the block, f32 accumulation (bfloat16 on the tensor cores
through ``wmma``, float32 on the CUDA cores), masked ragged edges so
``capacity`` need not be a multiple of the tile, and 64-bit offsets (at
Kimi-K2's expert FFN ``w`` has 5.6e9 elements).  Reading ``w`` once bounds
it at that width.

``bm`` / ``bn`` / ``bk`` / ``interpret`` were TPU tiling and Pallas mode
and are not taken here.
"""
from __future__ import annotations

import torch

from . import ref
from .build import check, load
from .dispatch import check_float, on_cuda, stream_of, suffix


def ragged_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  capacity: int) -> torch.Tensor:
    """``x`` (E*capacity, D) expert-contiguous times ``w`` (E, D, F).

    Row ``r`` uses expert ``r // capacity``; the sums are float32 and the
    output (E*capacity, F) is in ``x``'s dtype (float32 or bfloat16, the
    same for both inputs).  On CUDA tensors the kernel launches (and
    ``ragged_matmul.launches`` counts it); on CPU tensors the plain
    version in :mod:`repro_torch.kernels.ref` runs.
    """
    cuda = on_cuda(x, w)
    check_float("ragged_matmul", x, w)
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
        fn = getattr(load("ragged_matmul"),
                     f"ragged_matmul_{suffix(x.dtype)}")
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e,
                     capacity, d, f, stream_of(x))
        check(err, "ragged_matmul")
        ragged_matmul.launches += 1
    return out


#: kernel launches since the count was last set to 0
ragged_matmul.launches = 0
