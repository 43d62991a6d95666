"""Dispatch and argument checks shared by the kernel wrappers.

The rule has one input: where the tensors lie.  A CUDA tensor goes to the
hand-written kernel, which launches or raises; a CPU tensor goes to the
plain version in :mod:`repro_torch.kernels.ref`.  No environment variable
or keyword selects the plain version for a CUDA tensor.
"""
from __future__ import annotations

import torch

#: element types the kernels are built for
DTYPES = (torch.int32, torch.float32)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises otherwise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def check_table_idx(table: torch.Tensor, idx: torch.Tensor) -> None:
    """Shape, dtype and layout checks common to both kernels."""
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D (rows, d), got "
                         f"{tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"table dtype {table.dtype} not supported "
                        f"(int32 or float32)")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a 1-D int32 tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if idx.shape[0] and table.shape[0] == 0:
        raise ValueError("cannot index a table with no rows")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
