"""Dispatch and argument checks shared by the kernel wrappers.

The rule has one input: where the tensors lie.  A CUDA tensor goes to the
hand-written kernel, which launches or raises; a CPU tensor goes to the
plain version in :mod:`repro_torch.kernels.ref`.  No environment variable
or keyword selects the plain version for a CUDA tensor.
"""
from __future__ import annotations

import torch

#: element types the two speculative kernels' tensor route is built for
#: (bfloat16 for the MoE dispatch; the staged route is int32 only)
DTYPES = (torch.int32, torch.float32, torch.bfloat16)
#: element types the grouped-GEMM and attention kernels are built for
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


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


def resolve_device(device, who: str) -> torch.device:
    """``device``, or ``cuda`` when None; raises when a CUDA device is
    asked for and there is none, so an entry point never falls back to
    the CPU unasked.  ``who`` names the entry point in the error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available (pass "
                           f"device='cpu' to run on the CPU)")
    return dev


def check_table_idx(table: torch.Tensor, idx: torch.Tensor) -> None:
    """Shape, dtype and layout checks common to both kernels."""
    if table.dim() != 2:
        raise ValueError(f"table must be 2-D (rows, d), got "
                         f"{tuple(table.shape)}")
    if table.dtype not in DTYPES:
        raise TypeError(f"table dtype {table.dtype} not supported "
                        f"(int32, float32 or bfloat16)")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise TypeError(f"idx must be a 1-D int32 tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if idx.shape[0] and table.shape[0] == 0:
        raise ValueError("cannot index a table with no rows")


def check_float(name: str, *tensors: torch.Tensor) -> None:
    """One float dtype of :data:`FLOAT_DTYPES` for all, all contiguous."""
    dtype = tensors[0].dtype
    if dtype not in FLOAT_DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32 or "
                        f"bfloat16)")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def suffix(dtype: torch.dtype) -> str:
    """The C entry's dtype suffix: ``i32``, ``f32`` or ``bf16``."""
    return {torch.int32: "i32", torch.bfloat16: "bf16"}.get(dtype, "f32")


def aligned16(t: torch.Tensor) -> bool:
    """True when ``t``'s first element sits on a 16-byte boundary, as a
    TMA tensor map needs."""
    return t.data_ptr() % 16 == 0


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
