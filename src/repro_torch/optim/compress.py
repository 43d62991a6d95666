"""Error-feedback int8 gradient compression for the DP all-reduce
(counterpart of the JAX package's ``optim/compress.py``).

Speculation discipline applied to communication: gradients are quantized
(speculatively lossy), the residual is carried forward locally (the error
feedback "poison ledger"), so no information is ever replayed or lost in
expectation.  Off by default; wire with ``make_train_step(...,
compress=True)``.

The scale is the max over the reference's leaf, which stacks the
groups: the same-named gradients of every group share one scale here
too (:func:`~repro_torch.optim.tree.leaves`).  The residual has the
parameters' layout, float32, and is updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .tree import leaves, map_parts


def quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 payload of ``g`` (float32) at ``scale``."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def error_feedback_compress(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Returns (dequantized-compressed grads, new residual).

    The all-reduce then runs over the int8-representable payload; with the
    residual added next step, the scheme is unbiased over time.
    """
    deq: Dict = {}
    for gl, rl in zip(leaves(grads), leaves(residual)):
        top = torch.stack([torch.max(torch.abs(g.float() + r))
                           for g, r in zip(gl.parts, rl.parts)]).max()
        scale = torch.clamp(top, min=1e-12) / 127.0
        for i, (g, r) in enumerate(zip(gl.parts, rl.parts)):
            g = g.float() + r
            d = quantize(g, scale).to(torch.float32) * scale
            r.copy_(g - d)
            deq[gl.path, i if gl.stacked else None] = d
    return map_parts(lambda path, group, _: deq[path, group], grads), residual


def init_residual(params: Any) -> Any:
    return map_parts(lambda path, group, p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
