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

Under an ambient mesh (:func:`repro_torch.models.sharding.use_mesh`)
with a ``model`` axis, and a token count that the data axes divide,
:func:`moe_spec` picks the reference's mesh variant:

* **expert-parallel** (``E % model == 0``, Kimi-K2): every rank routes
  its own tokens against all experts, poisons the requests whose expert
  is not resident on its model shard (a remote expert is a
  mis-speculation, dropped and never replayed: it goes to the dump row
  ``e_loc`` of the slot arithmetic), runs its resident experts, and one
  all-reduce over ``model`` sums the partial outputs;
* **tensor-parallel** (else ``ff % model == 0``, Grok-1): every rank holds
  all experts with a 1/model slice of the FFN width, dispatches its
  tokens (capacity poison only) and all-reduces the f-partial expert
  outputs over ``model`` before the combine;
* otherwise the flat path.

Each variant is a local function (:func:`_ep_local`, :func:`_tp_local`:
one rank's arithmetic on plain tensors, where the reference has the body
of a ``shard_map``) and a wrapper that takes each input's local shard
(a DTensor is redistributed, a plain tensor is taken as the same full
value on every rank and sliced), calls it, and runs the collectives with
``torch.distributed.all_reduce`` on the mesh's groups.  Under
``kernel=True`` the local fill and combine call the same
``spec_scatter_add`` / ``spec_gather``: on the card the bf16 CUDA
entries, at ``E_loc = E / model`` experts a shard.  The global poison
count is the flat path's on every variant: EP sums the commits over
``model`` (a request commits on its expert's home shard only) and then
the poisoned over the data axes; TP sums over the data axes only (every
model shard dispatches the same tokens).

``stats=True`` also returns the number of poisoned dispatch requests as
an int32 scalar tensor.

While :mod:`repro_torch.spans` records, :func:`moe_spec` is a
``moe.layer`` span with the call's ``rows``, dispatch ``requests``
(rows x top-k) and ``experts_read`` (the experts whose weights the FFN
reads: all of them, the batched product runs over every expert's
capacity rows); the flat path adds ``poisoned`` and ``experts_touched``
(the distinct experts its routing chose, counted on the device) and
splits the layer into ``moe.route``, ``moe.dispatch``, ``moe.ffn``,
``moe.combine`` and ``moe.shared``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import spans
from ..kernels.spec_gather import spec_gather
from ..kernels.spec_scatter import spec_scatter_add
from .layers import swiglu
from .sharding import (Axis, SumAcross, axis_sizes, current_mesh, data_axes,
                       data_size, local, placements)


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
    pos = _arrivals(experts.reshape(-1)).reshape(n, k)
    slot = experts.to(torch.int32) * capacity + pos
    poison = pos >= capacity
    slot = torch.where(poison, torch.full_like(slot, -1), slot)
    return slot, torch.where(poison, torch.zeros_like(gates), gates)


def _arrivals(keys: torch.Tensor) -> torch.Tensor:
    """Each request's 0-based arrival position among the requests with
    its key, in request order (int32).  The reference counts arrivals
    with a cumsum over an (N*K, E) one-hot; a stable sort by key gives
    the same positions without the (N*K, E) scan, which on the card took
    a third of the prefill."""
    keys = keys.long()
    sorted_k, order = torch.sort(keys, stable=True)
    first = torch.searchsorted(sorted_k, sorted_k)        # key's start
    rank = torch.arange(keys.numel(), device=keys.device)
    pos = torch.empty_like(keys)
    pos[order] = rank - first
    return pos.to(torch.int32)


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
    the int32 count of poisoned dispatch requests out of ``N * top_k``
    (the same on every variant).  Under an ambient mesh it runs the
    reference's expert- or tensor-parallel variant (module docstring)."""
    sp = spans.ON and spans.open(
        "moe.layer", mark=True, rows=x.shape[0],
        requests=x.shape[0] * top_k, experts_read=n_experts)
    mesh = current_mesh()
    ff = params["w_gate"].shape[-1]
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, kernel=kernel, stats=stats)
    variant = None
    if (mesh is not None and "model" in mesh.mesh_dim_names
            and x.shape[0] % data_size(mesh) == 0):
        model_n = axis_sizes(mesh)["model"]
        if n_experts % model_n == 0:
            variant = _moe_spec_ep
        elif ff % model_n == 0:
            # few experts (Grok-1: 8 < 16 shards): replicate experts, TP
            # the expert FFN width, dispatch locally on every rank
            variant = _moe_spec_tp
    if variant is None:
        out = _moe_spec_flat(params, x, layer=sp, **kw)
    else:
        out = variant(params, x, mesh=mesh, **kw)
    if sp:
        spans.close(sp)
    return out


# ---------------------------------------------------------------------------
# one rank's arithmetic, shared by every variant
# ---------------------------------------------------------------------------


def _expert_ffn(x: torch.Tensor, flat_slot: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor, capacity: int,
                top_k: int, kernel: bool) -> torch.Tensor:
    """Speculative store of each request into its slot of the
    expert-contiguous buffer (poisoned slots drop), then the expert FFN
    over the buffer: ``(n_experts * capacity, d)``, ``n_experts`` being
    the experts (or f-slices) these weights hold."""
    d = x.shape[-1]
    e = wg.shape[0]
    src = x.repeat_interleave(top_k, dim=0)
    buf = torch.zeros((e * capacity, d), dtype=x.dtype, device=x.device)
    if kernel:
        # the kernel drops poisoned requests at commit itself
        buf = spec_scatter_add(buf, flat_slot, src)
    else:
        # poisoned requests still reach the memory system but commit
        # nothing: their payload is zeroed and their (clamped) slot-0
        # write adds 0
        poison = flat_slot < 0
        src = torch.where(poison[:, None], torch.zeros_like(src), src)
        buf.index_add_(0, flat_slot.clamp(min=0).long(), src)
    bufe = buf.view(e, capacity, d)
    g = torch.bmm(bufe, wg)
    u = torch.bmm(bufe, wu)
    h = torch.bmm(F.silu(g) * u, wd)
    return h.view(e * capacity, d)


def _combine(h: torch.Tensor, flat_slot: torch.Tensor, gates: torch.Tensor,
             kernel: bool) -> torch.Tensor:
    """Gather each request's expert output back (poisoned slots read
    zero) and sum a token's ``top_k`` outputs by their gates (a poisoned
    request's gate is 0)."""
    n, top_k = gates.shape
    d = h.shape[-1]
    if kernel:
        gathered = spec_gather(h, flat_slot)
    else:
        gathered = torch.where((flat_slot < 0)[:, None],
                               torch.zeros((), dtype=h.dtype,
                                           device=h.device),
                               h[flat_slot.clamp(min=0).long()])
    return (gathered.view(n, top_k, d) * gates[..., None].to(h.dtype)).sum(1)


def _moe_spec_flat(params: Dict, x: torch.Tensor, *, n_experts: int,
                   top_k: int, capacity_factor: float, kernel: bool = False,
                   stats: bool = False, layer=None):
    """Single-device / meshless speculative dispatch (the reference).
    ``layer``: the call's ``moe.layer`` span while the recorder is on,
    which takes the poisoned and touched counts."""
    n = x.shape[0]
    sp = layer and spans.open("moe.route", mark=True)
    _, gates, experts = _route(params, x, top_k)
    capacity = round_capacity(n, n_experts, top_k, capacity_factor)
    if sp:
        sp = spans.swap(sp, "moe.dispatch")
    slot, gates = spec_dispatch_indices(gates, experts, capacity, n_experts)
    flat_slot = slot.reshape(-1)
    if sp:
        sp = spans.swap(sp, "moe.ffn")
    h = _expert_ffn(x, flat_slot, params["w_gate"], params["w_up"],
                    params["w_down"], capacity, top_k, kernel)
    if sp:
        sp = spans.swap(sp, "moe.combine")
    out = _combine(h, flat_slot, gates, kernel)
    if sp:
        sp = spans.swap(sp, "moe.shared")
    out = _shared(params, x, out)
    if sp:
        spans.close(sp)
    if not (stats or layer):
        return out
    poisoned = (flat_slot < 0).sum(dtype=torch.int32)
    if layer:
        spans.put(layer, poisoned=poisoned,
                  experts_touched=experts_touched(experts, n_experts))
    return (out, poisoned) if stats else out


def experts_touched(experts: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The number of distinct experts in ``experts`` (int32 scalar), on
    its device and without a synchronise (``unique`` would wait for the
    count)."""
    hit = torch.zeros((n_experts,), dtype=torch.int32,
                      device=experts.device)
    return hit.index_fill_(0, experts.reshape(-1), 1).sum(dtype=torch.int32)


def _ep_local(router: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, x: torch.Tensor, shard: int, *,
              n_experts: int, top_k: int, capacity_factor: float,
              kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model shard ``shard``'s part of the expert-parallel variant: ``x``
    (n_loc, d) this rank's tokens, ``wg`` / ``wu`` / ``wd`` its ``e_loc``
    resident experts ``[shard * e_loc, (shard + 1) * e_loc)``.  Returns
    the partial output (n_loc, d), which sums over the model shards to
    the layer's output (without the shared experts), and the slot table
    (n_loc * top_k,) int32: ``local expert * capacity + position``, or
    -1 for a request poisoned here, by capacity or because its expert
    lives on another shard."""
    n_loc = x.shape[0]
    e_loc = wg.shape[0]
    lo = shard * e_loc
    _, gates, experts = _route({"router": router}, x, top_k)
    cap = round_capacity(n_loc, n_experts, top_k, capacity_factor)
    flat_e = experts.reshape(-1).to(torch.int32)
    is_local = (flat_e >= lo) & (flat_e < lo + e_loc)
    # non-resident experts queue on the dump row e_loc, poisoned below
    loc_e = torch.where(is_local, flat_e - lo, torch.full_like(flat_e,
                                                               e_loc))
    pos = _arrivals(loc_e)
    poison = (~is_local) | (pos >= cap)
    slot = torch.where(poison, torch.full_like(pos, -1), loc_e * cap + pos)
    gates = torch.where(poison.view(n_loc, top_k), torch.zeros_like(gates),
                        gates)
    h = _expert_ffn(x, slot, wg, wu, wd, cap, top_k, kernel)
    return _combine(h, slot, gates, kernel), slot


def _tp_local(router: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, x: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float, kernel: bool = False,
              ffn_x: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One model shard's part of the tensor-parallel variant: ``x``
    (n_loc, d) this rank's tokens, ``wg`` / ``wu`` (E, d, f_loc) and
    ``wd`` (E, f_loc, d) its slice of every expert's FFN width.  Returns
    the f-partial expert outputs (E * capacity, d), which sum over the
    model shards to the full ones, the slot table (n_loc * top_k,) int32
    (capacity poison only; equal on every shard) and the gates (n_loc,
    top_k) with poisoned requests' zeroed.  :func:`_combine` of the summed
    outputs finishes the layer.  ``ffn_x`` is the same tokens as the
    FFN's input (its gradient a partial sum over the shards, where the
    router's is whole on each); ``x`` when None."""
    n_loc = x.shape[0]
    _, gates, experts = _route({"router": router}, x, top_k)
    cap = round_capacity(n_loc, n_experts, top_k, capacity_factor)
    slot, gates = spec_dispatch_indices(gates, experts, cap, n_experts)
    flat = slot.reshape(-1)
    h = _expert_ffn(x if ffn_x is None else ffn_x, flat, wg, wu, wd, cap,
                    top_k, kernel)
    return h, flat, gates


# ---------------------------------------------------------------------------
# the mesh wrappers: local shards in, collectives, global results out
# ---------------------------------------------------------------------------


def _local(t: torch.Tensor, mesh, spec: Sequence[Axis],
           partial: Sequence[str] = ()) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec`` (a ``shard_map`` in_spec):
    a DTensor is redistributed and unwrapped; a plain tensor is the same
    full value on every rank and is sliced, mesh dimension by mesh
    dimension, the first outermost.  The gradient of the local value is
    a partial sum over the mesh axes ``partial`` (the transpose of a
    ``shard_map`` input that the body uses for its own part only)."""
    return local(t, mesh, placements(spec, mesh), partial)


def _global(t: torch.Tensor, like: torch.Tensor, mesh,
            spec: Sequence[Axis]) -> torch.Tensor:
    """The global value of local shards ``t`` under ``spec`` (a
    ``shard_map`` out_spec): a DTensor when ``like`` is one, else the
    full plain tensor (gathered over the sharded mesh dimensions; no
    collective where they all have size 1)."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, mesh)
    out = DTensor.from_local(t, mesh, pl, run_check=False)
    if isinstance(like, DTensor):
        return out
    if all(mesh.size(i) == 1 for i, p in enumerate(pl) if p.is_shard()):
        return t
    return out.full_tensor()


def _all_reduce(t: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum ``t`` in place over the mesh axes ``axes`` (``lax.psum``)."""
    for a in axes:
        dist.all_reduce(t, group=mesh.get_group(a))
    return t


def _moe_spec_ep(params: Dict, x: torch.Tensor, *, n_experts: int,
                 top_k: int, capacity_factor: float, mesh,
                 kernel: bool = False, stats: bool = False):
    dp = data_axes(mesh)
    wspec = ("model", None, None)
    # every model shard routes its tokens and runs its own experts: the
    # tokens' and the router's gradients are partial over ``model``, the
    # weights' over the data axes (each data shard's tokens)
    xl = _local(x, mesh, (dp, None), ("model",))
    partial, slot = _ep_local(
        _local(params["router"], mesh, (None, None), dp + ("model",)),
        _local(params["w_gate"], mesh, wspec, dp),
        _local(params["w_up"], mesh, wspec, dp),
        _local(params["w_down"], mesh, wspec, dp), xl,
        mesh.get_local_rank("model"), n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, kernel=kernel)
    # a request commits on exactly one model shard (its expert's home)
    # unless it lost the capacity race there, so summing commits over
    # ``model`` counts each surviving request once: globally identical
    # to the flat variant's accounting
    committed = _all_reduce((slot >= 0).sum(dtype=torch.int32)[None], mesh,
                            ("model",))
    poisoned = _all_reduce(xl.shape[0] * top_k - committed, mesh, dp)[0]
    out = _global(SumAcross.apply(partial, mesh, ("model",)), x, mesh,
                  (dp, None))
    out = _shared(params, x, out)
    return (out, poisoned) if stats else out


def _moe_spec_tp(params: Dict, x: torch.Tensor, *, n_experts: int,
                 top_k: int, capacity_factor: float, mesh,
                 kernel: bool = False, stats: bool = False):
    """Expert counts below the model-axis size: every rank holds all
    experts with a 1/model slice of the FFN width, dispatches its local
    tokens speculatively (capacity poison only), and all-reduces the
    f-partial expert outputs once per layer."""
    dp = data_axes(mesh)
    fspec = (None, None, "model")
    # the routing (and the combine after the all-reduce) is the same on
    # every model shard: its inputs' gradients are whole there; the FFN's
    # input gradient is partial over ``model`` (a slice of the width),
    # the weights' over the data axes
    xl = _local(x, mesh, (dp, None))
    h, flat, gates = _tp_local(
        _local(params["router"], mesh, (None, None), dp),
        _local(params["w_gate"], mesh, fspec, dp),
        _local(params["w_up"], mesh, fspec, dp),
        _local(params["w_down"], mesh, (None, "model", None), dp), xl,
        n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor,
        kernel=kernel, ffn_x=_local(x, mesh, (dp, None), ("model",)))
    out = _combine(SumAcross.apply(h, mesh, ("model",)), flat, gates, kernel)
    # every model shard dispatches the same replicated tokens, so the
    # local poison count is already the per-dp-shard total: sum over the
    # data axes only (summing over ``model`` would multiply-count)
    poisoned = _all_reduce((flat < 0).sum(dtype=torch.int32)[None], mesh,
                           dp)[0]
    out = _shared(params, x, _global(out, x, mesh, (dp, None)))
    return (out, poisoned) if stats else out


def run_shards(params: Dict, x: torch.Tensor, n_shards: int, *,
               variant: str, n_experts: int, top_k: int,
               capacity_factor: float, kernel: bool = False,
               each=None):
    """One data shard of a mesh variant with ``n_shards`` model shards,
    run in this process: every model shard's local function in turn on
    its slice of the weights, the partial results summed in shard order
    as the all-reduce over ``model`` sums them.  For a device that
    cannot hold a process group of ``n_shards`` ranks (NCCL takes one
    rank a card).  ``variant`` is ``"ep"`` or ``"tp"``; ``each(shard,
    slot)`` is called after each shard's local function.  Returns
    ``(out, poisoned, slots)``: the layer's output, the poisoned count
    (int32) and each shard's slot table."""
    names = ("w_gate", "w_up", "w_down")
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, kernel=kernel)
    total, slots = None, []
    for s in range(n_shards):
        if variant == "ep":
            e = n_experts // n_shards
            w = [params[k][s * e:(s + 1) * e] for k in names]
            part, slot = _ep_local(params["router"], *w, x, s, **kw)
        else:
            f = params["w_gate"].shape[-1] // n_shards
            cut = slice(s * f, (s + 1) * f)
            part, slot, gates = _tp_local(
                params["router"], params["w_gate"][..., cut],
                params["w_up"][..., cut], params["w_down"][:, cut], x, **kw)
        total = part if total is None else total + part
        slots.append(slot)
        if each is not None:
            each(s, slot)
    if variant == "ep":
        committed = sum((slot >= 0).sum(dtype=torch.int32) for slot in slots)
        poisoned = x.shape[0] * top_k - committed
    else:
        total = _combine(total, slots[0], gates, kernel)
        poisoned = (slots[0] < 0).sum(dtype=torch.int32)
    return _shared(params, x, total), poisoned, slots


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
