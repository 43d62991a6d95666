"""Mixture-of-Experts with speculative dispatch, the flat (meshless) path.

The counterpart of the JAX package's ``models/moe.py``.  Whether token
*t*'s activations are stored into expert *e*'s buffer is control-dependent
on ``top_k(router(x))``, the paper's control LoD.  Every token issues its
store into a fixed-capacity per-expert buffer; a request that loses the
capacity race gets its slot poisoned (``-1``) and is dropped at commit,
never replayed; the combine gathers back with poisoned slots contributing
zero.

* ``kernel=False`` (``dispatch="spec"``): the buffer fill is an
  ``index_add_`` of the masked rows and the combine an indexed read.
* ``kernel=True`` (``dispatch="spec-kernel"``): the fill runs through
  :func:`repro_torch.kernels.spec_scatter.spec_scatter_add` and the combine
  through :func:`repro_torch.kernels.spec_gather.spec_gather`, on the card
  the hand-written CUDA kernels (bfloat16 at the models' widths).
  Bit-identical to ``kernel=False``: every live slot receives exactly one
  token, so both compute ``0 + row``.
* :func:`moe_dense`: the if-converted baseline, every token through every
  expert, gated.

The expert FFN is a batched matrix product over the expert-contiguous
buffer, as in the reference (which does not call ``ragged_matmul`` here).
The expert-parallel and tensor-parallel mesh variants of the reference
are not ported yet: :func:`moe_spec` takes no mesh.

``stats=True`` also returns the number of poisoned dispatch requests as
an int32 scalar tensor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.spec_gather import spec_gather
from ..kernels.spec_scatter import spec_scatter_add
from .layers import swiglu


def round_capacity(n_tokens: int, n_experts: int, top_k: int,
                   factor: float, multiple: int = 8) -> int:
    cap = int(factor * n_tokens * top_k / n_experts) + 1
    return max(multiple, ((cap + multiple - 1) // multiple) * multiple)


def spec_dispatch_indices(gates: torch.Tensor, experts: torch.Tensor,
                          capacity: int, n_experts: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """AGU slice: speculative slot assignment.

    gates/experts: (N, K).  Returns (slot, gates): slot (N, K) int32 is
    ``expert * capacity + position`` (position = 0-based arrival order
    within the expert, requests taken in row-major (N, K) order) or
    **-1 (poison)** where the position reaches the capacity; a poisoned
    request's gate is 0.
    """
    n, k = experts.shape
    flat_e = experts.reshape(-1).long()                   # request order
    # the reference counts arrivals with a cumsum over an (N*K, E)
    # one-hot; a stable sort by expert gives the same positions without
    # the (N*K, E) scan, which on the card took a third of the prefill
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)        # expert's start
    rank = torch.arange(flat_e.numel(), device=flat_e.device)
    pos = torch.empty_like(flat_e)
    pos[order] = rank - first
    pos = pos.to(torch.int32).reshape(n, k)
    slot = experts.to(torch.int32) * capacity + pos
    poison = pos >= capacity
    slot = torch.where(poison, torch.full_like(slot, -1), slot)
    return slot, torch.where(poison, torch.zeros_like(gates), gates)


def _route(params: Dict, x: torch.Tensor, top_k: int):
    """Router probabilities (float32) and their top-k, descending, the
    lower expert first among equal probabilities (``jax.lax.top_k``'s
    order, which ``torch.topk`` does not promise)."""
    logits = x @ params["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, gates[..., :top_k], experts[..., :top_k]


def _shared(params: Dict, x: torch.Tensor, out: torch.Tensor):
    if "shared_w_gate" in params:
        out = out + swiglu(x, params["shared_w_gate"], params["shared_w_up"],
                           params["shared_w_down"])
    return out


def moe_spec(params: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
             capacity_factor: float, kernel: bool = False,
             stats: bool = False):
    """Speculative MoE layer.  x: (N, d) -> (N, d); with ``stats`` also
    the int32 count of poisoned dispatch requests out of ``N * top_k``."""
    n, d = x.shape
    _, gates, experts = _route(params, x, top_k)
    capacity = round_capacity(n, n_experts, top_k, capacity_factor)
    slot, gates = spec_dispatch_indices(gates, experts, capacity, n_experts)
    flat_slot = slot.reshape(-1)
    poison = flat_slot < 0

    # --- speculative store into the expert buffer (poison drops) ----------
    src = x.repeat_interleave(top_k, dim=0)
    buf = torch.zeros((n_experts * capacity, d), dtype=x.dtype,
                      device=x.device)
    if kernel:
        # the kernel drops poisoned requests at commit itself
        buf = spec_scatter_add(buf, flat_slot, src)
    else:
        # poisoned requests still reach the memory system but commit
        # nothing: their payload is zeroed and their (clamped) slot-0
        # write adds 0
        src = torch.where(poison[:, None], torch.zeros_like(src), src)
        buf.index_add_(0, flat_slot.clamp(min=0).long(), src)

    # --- expert FFN over the contiguous buffer ----------------------------
    bufe = buf.view(n_experts, capacity, d)
    g = torch.bmm(bufe, params["w_gate"])
    u = torch.bmm(bufe, params["w_up"])
    h = torch.bmm(F.silu(g) * u, params["w_down"])
    h = h.view(n_experts * capacity, d)

    # --- combine: gather back, poisoned slots contribute zero -------------
    if kernel:
        gathered = spec_gather(h, flat_slot)
    else:
        gathered = torch.where(poison[:, None], torch.zeros((), dtype=h.dtype,
                                                            device=h.device),
                               h[flat_slot.clamp(min=0).long()])
    out = (gathered.view(n, top_k, d) * gates[..., None].to(h.dtype)).sum(1)
    out = _shared(params, x, out)
    if stats:
        return out, poison.sum(dtype=torch.int32)
    return out


def moe_dense(params: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              stats: bool = False, **_: object):
    """If-conversion baseline: all tokens x all experts, gated (no
    speculation, so nothing is poisoned)."""
    probs, gates, experts = _route(params, x, top_k)
    mask = torch.zeros_like(probs).scatter_(1, experts, gates)
    g = torch.einsum("nd,edf->nef", x, params["w_gate"])
    u = torch.einsum("nd,edf->nef", x, params["w_up"])
    h = torch.einsum("nef,efd->ned", F.silu(g) * u, params["w_down"])
    out = torch.einsum("ned,ne->nd", h, mask.to(h.dtype))
    out = _shared(params, x, out)
    if stats:
        return out, torch.zeros((), dtype=torch.int32, device=x.device)
    return out
