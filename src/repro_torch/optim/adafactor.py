"""Adafactor: factored second moments, no first moment (counterpart of
the JAX package's ``optim/adafactor.py``), the optimiser above 100e9
parameters: its state is O(rows + cols) a matrix instead of
O(rows x cols).

The reference applies it to stacked group leaves, and that changes its
numbers: a leaf of two or more dimensions is factored, so a per-layer
vector (``ln``, a bias, RWKV's and Mamba's vectors), stacked to
``(G, d)``, is factored across the groups, and each leaf's update is
clipped by the RMS of the whole stack.  This port does the same over
:func:`~repro_torch.optim.tree.leaves`: the state ``vr`` / ``vc`` has the
reference's layout and shapes (groups stacked, float32), and each leaf's
gradient is stacked into one float32 copy, the reference's own
temporary.  ``update`` writes the new parameters into the old ones and
returns the same tree; it holds one leaf's float32 temporaries at a time
(at most two copies of it).  ``beta``, the step and the schedule are
float32 tensors, as ``jnp`` computes them against an int32 step.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from .tree import Leaf, at, leaves, stack_f32, stacked_tree


def _placed_for(v: torch.Tensor, g: torch.Tensor, dim: int) -> torch.Tensor:
    """The moment ``v``, ``g``'s statistic over dimension ``dim``, placed
    as ``g`` is (its shards of the other dimensions kept, of ``dim``
    replicated), so that the update built from it moves none of ``g``
    (the state keeps its own placements); a plain ``v`` as it is."""
    if not hasattr(g, "placements"):
        return v
    from torch.distributed.tensor import Replicate, Shard
    dim %= g.ndim
    pl = [Shard(p.dim - (p.dim > dim)) if p.is_shard() and p.dim != dim
          else Replicate() for p in g.placements]
    return v.redistribute(v.device_mesh, pl)


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any   # row second moments (or full moment for vectors)
    vc: Any   # col second moments (or empty)


def adafactor(lr: Callable[[torch.Tensor], torch.Tensor] | float, *,
              decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def _factored(leaf: Leaf) -> bool:
        return len(leaf.shape) >= 2

    def zeros(leaf: Leaf, shape):
        return torch.zeros(shape, dtype=torch.float32,
                           device=leaf.parts[0].device)

    def init(params) -> AdafactorState:
        ls = leaves(params)

        def vr(leaf):
            s = leaf.shape
            return zeros(leaf, s[:-1] if _factored(leaf) else s)

        def vc(leaf):
            s = leaf.shape
            return zeros(leaf, s[:-2] + s[-1:] if _factored(leaf) else (0,))

        return AdafactorState(
            torch.zeros((), dtype=torch.int32, device=ls[0].parts[0].device),
            stacked_tree(ls, vr), stacked_tree(ls, vc))

    @torch.no_grad()
    def update(grads, state: AdafactorState, params
               ) -> Tuple[Any, AdafactorState]:
        step = state.step + 1
        beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-decay)
        lr_t = lr_fn(step)
        for gl, pl in zip(leaves(grads), leaves(params)):
            vr, vc = at(state.vr, gl.path), at(state.vc, gl.path)
            g = stack_f32(gl)
            g2 = g.square().add_(eps)
            if _factored(gl):
                vr.mul_(beta).add_(g2.mean(-1).mul_(1 - beta))
                vc.mul_(beta).add_(g2.mean(-2).mul_(1 - beta))
                del g2
                # factored normalization: g / sqrt(vr ⊗ vc / mean(vr))
                r, c = _placed_for(vr, g, -1), _placed_for(vc, g, -2)
                u = r[..., None] * c[..., None, :]
                u.div_(torch.clamp(r.mean(-1, keepdim=True),
                                   min=eps)[..., None])
                u.add_(eps).rsqrt_().mul_(g)
            else:
                vr.mul_(beta).add_(g2.mul_(1 - beta))
                del g2
                u = (vr + eps).rsqrt_().mul_(g)
            del g
            rms = torch.sqrt(u.square().mean() + eps)
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            if weight_decay:
                u.add_(stack_f32(pl), alpha=weight_decay)
            u.mul_(lr_t)
            for i, p in enumerate(pl.parts):
                p.copy_(p.float().sub_(u[i] if pl.stacked else u))
        return params, AdafactorState(step, state.vr, state.vc)

    return init, update
