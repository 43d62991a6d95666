"""AdamW with global-norm clipping (counterpart of the JAX package's
``optim/adamw.py``).

The same ``(init, update)`` pair over a parameter tree.  The moments are
float32 and have the parameters' layout (one tensor a parameter, groups
in a list); AdamW is elementwise apart from the global norm, so the
reference's stacking of the groups changes nothing.  The step is an
int32 tensor and the bias corrections are computed from it in float32,
as in the reference.

``update`` works in place, one parameter at a time: it updates the
moments with ``mul_`` / ``add_`` / ``addcmul_``, writes the new
parameter into the old one (cast back to its dtype) and returns the
same tree and state.  It holds one parameter's float32 temporaries at a
time, a few copies of the largest leaf, which is what lets
Phi-4-mini's 4.45e9 parameters train on one 80 GB card beside their
35.6 GB of moments.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from .tree import leaves, map_parts


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float, *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def zeros(path, group, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(params) -> AdamWState:
        device = leaves(params)[0].parts[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          map_parts(zeros, params), map_parts(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        flat = [(g, m, v, p) for gl, ml, vl, pl in zip(
            leaves(grads), leaves(state.m), leaves(state.v), leaves(params))
            for g, m, v, p in zip(gl.parts, ml.parts, vl.parts, pl.parts)]
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g, _, _, _ in flat))
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        lr_t = lr_fn(step)
        c1 = 1 - b1 ** step.to(torch.float32)
        c2 = 1 - b2 ** step.to(torch.float32)
        for g, m, v, p in flat:
            g = g.to(torch.float32, copy=True).mul_(scale)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            u = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
            u.add_(p.float(), alpha=weight_decay).mul_(lr_t)
            p.copy_(p.float().sub_(u))
        return params, AdamWState(step, state.m, state.v)

    return init, update
