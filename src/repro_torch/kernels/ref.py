"""Plain PyTorch versions of the kernels (the semantic ground truth).

Semantics follow the reference oracle of the JAX package: a *negative
index* marks a mis-speculated request — a gather returns a zero row for
it, a scatter drops it — and an index of at least the row count clips to
the last row.  The wrappers in :mod:`repro_torch.kernels.spec_gather` and
:mod:`repro_torch.kernels.spec_scatter` run these on CPU tensors; on the
card they are what the CUDA kernels are held against.
"""
from __future__ import annotations

import torch


def _safe(idx: torch.Tensor, rows: int) -> torch.Tensor:
    return idx.clamp(0, rows - 1).long()


def spec_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``; poisoned (idx<0) rows are zeros."""
    rows = table[_safe(idx, table.shape[0])]
    return torch.where((idx < 0)[:, None], torch.zeros_like(rows), rows)


def spec_scatter_add(table: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] += values[i]`` in place, poisoned (idx<0) stores
    dropped; duplicate indices add up.  Returns ``table``."""
    vals = torch.where((idx < 0)[:, None], torch.zeros_like(values), values)
    return table.index_put_((_safe(idx, table.shape[0]),), vals,
                            accumulate=True)
