"""Core layers: RMSNorm, RoPE, GQA attention, SwiGLU.

The counterpart of the JAX package's ``models/layers.py``: pure functions
over parameter dictionaries, the same arithmetic in the same dtypes
(float32 statistics and softmax state, everything else in the
activations' dtype).  The reference's sharding constraints sit at the
same points with the same axes (:func:`repro_torch.models.sharding.constrain`):
under an ambient mesh they redistribute DTensor activations, and they
pass plain tensors through, so every path over plain tensors is
unchanged, bit for bit.  Where the port's layout differs from the
reference's (the queries are ``(B, T, H, hd)`` until RoPE), the axes
follow the dimensions they name.

Under a mesh the layers move what the reference's partitioned program
moves and no more: a KV cache sharded on T is written and attended
shard by shard (:func:`_sharded_cache_attention`), the partial sums of
row-parallel products are reduced once
(:func:`repro_torch.models.sharding.reduce`), FSDP weights are gathered
where they meet activations (:func:`weight`), and a projection whose
column shards are not whole heads gathers the smaller of its weight and
its product (:func:`whole_product`).

Attention keeps the reference's masking exactly, and its NEG_INF is
**finite** (``-1e30``) on purpose: a query row with no live key (a row
inside a left pad, during prefill) gets a uniform softmax over its
masked cache and so a finite mean of V, as in the reference.  That row
then goes on through the MoE router and takes capacity slots, so the
serving engine's poison counts and surviving tokens depend on it.  The
port's ``flash_attention`` / ``paged_attention`` kernels return zeros for
such rows (right for the kernel API) and are therefore not used here;
the reference's model stack does not call its Pallas attention kernels
either.  Attention without a cache (training, the encoder, cross
attention) is the reference's device loop over key chunks, which on
CUDA tensors runs as the chunked-attention kernels
(:func:`chunked_attention`): there every row has a live key, so the
finite NEG_INF never decides a softmax.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import spans
from ..kernels import chunked_attention as attention
from .sharding import (constrain, current_mesh, data_axes, is_dtensor,
                       local, local_call, reduce, shard_span, unshard)

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); pos: (T,) or (B, T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].float() * freqs                  # (..., T, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)        # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def weight(w: torch.Tensor) -> torch.Tensor:
    """A weight as a product takes it: under a mesh, an FSDP-sharded
    DTensor is gathered over the data axes (the reference's FSDP
    all-gather of the weight, not of the activations it meets); any
    other tensor as it is."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(w):
        return w
    return unshard(w, data_axes(mesh))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ weight(w_gate)
    u = x @ weight(w_up)
    if g.ndim == 3:  # (B, T, ff): TP on the hidden dim, DP on batch
        g = constrain(g, "dp", None, "model")
        u = constrain(u, "dp", None, "model")
    out = (F.silu(g) * u) @ weight(w_down)
    return reduce(out, "dp", *(None,) * (out.ndim - 1))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 512,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the reference's
    ``lax.scan``): :func:`repro_torch.kernels.chunked_attention.
    chunked_attention`, the CUDA kernels on CUDA tensors, forward and
    backward, and the plain loop on CPU tensors.

    q, k, v: (B, H, T, d) with equal head counts: the caller expands GQA.
    Attention is independent per (batch row, head), so on CUDA DTensors
    each rank runs the kernels on its own shards of both and nothing is
    gathered (:func:`repro_torch.models.sharding.local_call`).  On CPU
    the plain loop takes DTensors as they are, and DTensor runs each of
    its steps on the ranks' shards: the dry run (fake CPU tensors)
    counts that loop, as it did before the kernels.
    """
    assert k.shape[1] == q.shape[1], \
        "expand GQA heads before chunked_attention"

    def attend(q, k, v):
        return attention.chunked_attention(q, k, v, causal=causal,
                                           q_offset=q_offset, chunk=chunk)
    if q.device.type == "cpu":
        return attend(q, k, v)
    return local_call(attend, (q, k, v), _ATTN_DIMS)


#: where the batch (0) and the heads (1) of q lie in q, k and v, then in
#: the output
_ATTN_DIMS = ([{0: 0, 1: 1}] * 3, [{0: 0, 1: 1}])


def whole_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``, replicated over ``model`` under a mesh: the weight or
    the product is gathered over the axis first, whichever is smaller
    (the weight when many tokens meet it, as in training and prefill;
    the product in decode).  On plain tensors, the product."""
    w = weight(w)
    mesh = current_mesh()
    if mesh is None or not is_dtensor(w) or "model" not in \
            mesh.mesh_dim_names:
        return x @ w
    rows = 1
    for n in (x.to_local() if is_dtensor(x) else x).shape[:-1]:
        rows *= n
    if w.shape[0] <= rows:  # the weight has fewer elements
        return x @ unshard(w, ("model",))
    return unshard(x @ w, ("model",))


def project(x: torch.Tensor, w: torch.Tensor, n: int,
            hd: int) -> torch.Tensor:
    """``x @ w`` as ``(B, T, n, hd)`` heads.  Under a mesh, a weight whose
    column shards over ``model`` are not whole heads (``n`` not divisible
    by the axis: Mistral-NeMo's 8 K/V heads on 16 shards) cannot be
    viewed as heads, so the product is made whole over ``model``
    (:func:`whole_product`), where DTensor would gather the product over
    every axis."""
    b, t, _ = x.shape
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names or n % mesh.size(
            mesh.mesh_dim_names.index("model")) == 0:
        return (x @ weight(w)).view(b, t, n, hd)
    return whole_product(x, w).view(b, t, n, hd)


def kv_heads(x: torch.Tensor, w: torch.Tensor, n: int, n_heads: int,
             hd: int) -> torch.Tensor:
    """``x @ w`` as (B, n, S, hd) K/V heads, for ``n_heads`` query heads.

    Under a mesh whose ``model`` axis cuts each of the ``n`` heads into
    ``c = m / n`` column pieces (``m`` the axis size, a multiple of
    ``n`` and of ``n_heads``: Llama-3.2-Vision's 8 K/V heads of its cross
    sublayers on 16 shards), the ``c`` ranks that hold the pieces of one
    head hold query heads of that head only.  Each multiplies its own
    columns, takes the other pieces from those peers by one all-to-all
    over ``model`` (a piece a peer; :func:`whole_product` would gather
    the whole weight or product), and returns the head repeated for its
    query heads: (B, n_heads, S, hd) sharded on heads over ``model``,
    GQA-expanded.  Elsewhere :func:`project`'s heads."""
    mesh = current_mesh()
    mdim = (mesh.mesh_dim_names.index("model") if mesh is not None
            and "model" in mesh.mesh_dim_names else None)
    m = 1 if mdim is None else mesh.size(mdim)
    if not (is_dtensor(w) and m > n and m % n == 0 and n_heads % m == 0
            and w.placements[mdim].is_shard(1)):
        return project(x, w, n, hd).transpose(1, 2)
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate, Shard
    c, rank = m // n, mesh.get_local_rank("model")
    w = weight(w)
    # each rank uses the whole memory for its own piece, and its tokens
    # for the weight's: the gradients are partial over ``model`` and the
    # data axes
    x_pl = [Replicate() if i == mdim else p for i, p in enumerate(
        x.placements if is_dtensor(x) else [Replicate()] * mesh.ndim)]
    piece = local(x, mesh, x_pl, ("model",)) @ local(
        w, mesh, w.placements, data_axes(mesh))           # (B, S, hd / c)
    first = rank - rank % c
    sizes = [piece.shape[0] if first <= j < first + c and j != rank else 0
             for j in range(m)]
    got = fc.all_to_all_single_autograd(
        piece.repeat(c - 1, 1, 1), sizes, sizes, mesh.get_group(mdim))
    got = list(got.split(piece.shape[0]))
    head = torch.cat(got[:rank - first] + [piece] + got[rank - first:],
                     dim=-1)                              # (B, S, hd)
    out = head[:, None].repeat(1, n_heads // m, 1, 1)
    return DTensor.from_local(
        out, mesh, [Shard(1) if i == mdim else p for i, p in enumerate(x_pl)],
        run_check=False)


def _queries(params: Dict, x: torch.Tensor, n_heads: int,
             head_dim: int) -> torch.Tensor:
    """The queries (B, T, H, hd).  They shard on heads over the model
    axis; K/V stay replicated across it and expand to full heads
    locally, so every score and context product is communication-free."""
    q = project(x, params["wq"], n_heads, head_dim)
    return constrain(q, "dp", None, "model", None)


def _self_qkv(params: Dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
              head_dim: int, theta: float, pos_offset: int, pad_len):
    """Self-attention's rotated queries (B, H, T, hd) and keys and values
    (B, Hkv, T, hd).  Over ``model`` the queries shard on heads, and so do
    the keys and values where the axis divides their heads (as the
    projection gives them: the scores are then local); elsewhere they
    are replicated, and expand to full heads locally.  With ``pad_len``
    the positions count each row's real tokens only."""
    t = x.shape[1]
    q = _queries(params, x, n_heads, head_dim)
    k = project(x, params["wk"], n_kv_heads, head_dim)
    v = project(x, params["wv"], n_kv_heads, head_dim)
    pos = pos_offset + torch.arange(t, device=x.device)
    if pad_len is not None:
        # per-row real-token positions; pad rows clamp to 0 but are
        # masked out of attention below, so their rotation is dead
        pos = torch.clamp(pos[None, :] - pad_len[:, None].long(), min=0)
    q = rope(q, pos, theta).transpose(1, 2)                 # (B, H, T, hd)
    k = constrain(rope(k, pos, theta).transpose(1, 2),
                  "dp", "model", None, None)
    v = constrain(v.transpose(1, 2), "dp", "model", None, None)
    return q, k, v


def gqa_attention(params: Dict, x: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, theta: float,
                  pos_offset: int = 0, kv_cache: Optional[Tuple] = None,
                  cache_len: int = 0,
                  cross_kv: Optional[Tuple] = None, causal: bool = True,
                  pad_len: Optional[torch.Tensor] = None):
    """GQA attention block (pre-norm outside).  Returns (out, new_kv).

    kv_cache: (k, v) of shape (B, Hkv, Tmax, hd); the new keys and values
    are written at ``cache_len`` **in place** (the reference returns
    updated copies; every caller here owns its cache) and the queries
    attend over the valid prefix.  A DTensor cache sharded on T over the
    mesh (the dry run's and the reference's sequence-parallel layout) is
    written and attended shard by shard (:func:`_sharded_cache_attention`),
    never gathered.  cross_kv: precomputed (k, v) of shape
    (B, Hkv, S, hd) for cross-attention (enc-dec, VLM): no RoPE, not
    causal, no cache, no pad mask; or (B, H, S, hd), expanded to the query
    heads (:func:`kv_heads`).  pad_len: (B,) int32, per-row left-pad
    length: RoPE positions count real tokens only and the pad columns are
    masked out of every attention read.
    """
    b, t, dm = x.shape
    rep = n_heads // n_kv_heads
    # spans (repro_torch.spans) of the serving path: a plain KV cache
    sp = spans.ON and kv_cache is not None and not is_dtensor(
        kv_cache[0]) and spans.open("attn.qkv", mark=True)
    if cross_kv is None:
        q, k, v = _self_qkv(params, x, n_heads, n_kv_heads, head_dim, theta,
                            pos_offset, pad_len)
    else:
        q = _queries(params, x, n_heads, head_dim).transpose(1, 2)
        k, v = cross_kv
        causal = False
        rep = n_heads // k.shape[1]     # 1 for heads already expanded

    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        if cache_len + t > ck.shape[2]:
            raise ValueError(f"{t} tokens at {cache_len} overflow a cache "
                             f"of {ck.shape[2]}")
        new_cache = (ck, cv)
        if is_dtensor(ck):
            out = _sharded_cache_attention(q, k, v, ck, cv, cache_len,
                                           pad_len)
        else:
            if sp:
                sp = spans.swap(sp, "attn.cache")
            ck[:, :, cache_len:cache_len + t] = k.to(ck.dtype)
            cv[:, :, cache_len:cache_len + t] = v.to(cv.dtype)
            if sp:
                sp = spans.swap(sp, "attn.expand")
            cke = ck.repeat_interleave(rep, dim=1) if rep > 1 else ck
            cve = cv.repeat_interleave(rep, dim=1) if rep > 1 else cv
            if sp:
                sp = spans.swap(sp, "attn.core")
            out = _decode_attention(q, cke, cve, cache_len + t,
                                    pad_len=pad_len)
        out = out.reshape(b, t, n_heads * head_dim)
    else:
        if rep > 1:
            k = constrain(_expand(k, rep), "dp", "model", None, None)
            v = constrain(_expand(v, rep), "dp", "model", None, None)
        out = chunked_attention(q, k, v, causal=causal, q_offset=pos_offset)
        out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim)
    if sp:
        sp = spans.swap(sp, "attn.out")
    out = constrain(out, "dp", None, "model")
    out = reduce(out @ weight(params["wo"]), "dp", None, None)
    if sp:
        spans.close(sp)
    return out, new_cache


def _attend(q: torch.Tensor, ck: torch.Tensor, k_pos: torch.Tensor,
            valid_len: int, pad_len: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked float32 scores of ``q`` (B, H, t, d) against keys ``ck``
    (B, H, T, d) at cache positions ``k_pos`` (T,): a key counts for a
    query at or after it (the queries sit at ``valid_len - t`` on) and
    outside its row's left pad."""
    t, d = q.shape[2], q.shape[3]
    s = (q @ ck.transpose(-1, -2)).float()
    s = s / (d ** 0.5)
    q_pos = valid_len - t + torch.arange(t, device=q.device)    # (t,)
    ok = k_pos[None, :] <= q_pos[:, None]                       # (t, T)
    if pad_len is not None:
        alive = k_pos[None, :] >= pad_len[:, None].long()       # (B, T)
        ok = (ok[None] & alive[:, None])[:, None]               # (B,1,t,T)
    return torch.where(ok, s, torch.full((), NEG_INF, device=q.device))


def _decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      valid_len: int,
                      pad_len: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Few-token attention over a (B, H, Tmax, d) cache with a validity
    mask: the full cache is read, columns past the end are masked, the new
    tokens attend causally among themselves.  ``pad_len`` ((B,) int32)
    also masks the left-pad columns at the start of the cache.  Returns
    (B, t, H, d)."""
    assert ck.shape[1] == q.shape[1], \
        "expand GQA heads before _decode_attention"
    k_pos = torch.arange(ck.shape[2], device=q.device)          # (Tmax,)
    p = torch.softmax(_attend(q, ck, k_pos, valid_len, pad_len), dim=-1)
    out = p.to(cv.dtype) @ cv
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# a T-sharded cache, shard by shard
# ---------------------------------------------------------------------------


def _sharded_cache_attention(q, k, v, ck, cv, cache_len: int,
                             pad_len) -> torch.Tensor:
    """Write the new keys and values into a DTensor cache sharded on T
    and attend it, shard by shard; returns the (B, t, H, d) output as a
    DTensor.

    Each rank writes the positions of ``[cache_len, cache_len + t)``
    that fall in its T-shard into its local cache (no gather; DTensor
    would gather the whole cache for a slice write into a sharded
    dimension).  Attention then takes the cheaper of two layouts, as the
    reference's partitioner does:

    * **sequence-parallel** (decode: few queries, a long cache): the
      queries are replicated over the T-sharding mesh dimensions, each
      rank scores its T-shard, and the row max, the exponentials' sum and
      the partial ``p @ v`` are reduced across them (:func:`seq_parallel`:
      max and sum of the float32 softmax state, sum of the contexts in
      the values' dtype); no scores and no cache are ever gathered.
      Masks use each shard's global key positions.
    * **heads-parallel** (a prefill that fills the cache: as many
      queries as keys): the queries stay sharded on heads, and one
      all-to-all turns each rank's T-shard of the GQA-expanded cache
      into all of T for its heads; attention is then local.  Chosen when
      the queries weigh at least the cache's all-to-all (``t * n >=
      2 * Tmax`` for ``n`` T-shards) and the heads divide over one mesh
      dimension.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ck.device_mesh
    b, hq, t, d = q.shape
    rep = hq // ck.shape[1]
    tmax = ck.shape[2]
    lo, n_loc, tdims = shard_span(ck, 2)
    n_t = tmax // n_loc
    kv_pl = [Replicate() if i in tdims else p
             for i, p in enumerate(ck.placements)]
    h_pl = [Shard(1) if i in tdims else p for i, p in enumerate(kv_pl)]
    group = mesh.get_group(tdims[0]) if len(tdims) == 1 else None
    ckl, cvl = ck.to_local(), cv.to_local()
    for c, new in ((ckl, k), (cvl, v)):
        if (group is not None and cache_len == 0 and t == tmax
                and is_dtensor(new) and new.placements[tdims[0]].is_shard(1)):
            # a prefill that fills the cache with keys sharded on heads:
            # one all-to-all turns them into this rank's T-shard
            c.copy_(_shards_from_heads(local(new, mesh, h_pl), group, n_t))
        else:
            _shard_write(c, local(new, mesh, kv_pl), cache_len, lo)
    b_pl = [Shard(0) if p.is_shard(0) else Replicate()
            for p in ck.placements]
    padl = None if pad_len is None else local(pad_len, mesh, b_pl)
    if group is not None and hq % n_t == 0 and t * n_t >= 2 * tmax:
        out = _decode_attention(local(q, mesh, h_pl),
                                _heads_from_shards(_expand(ckl, rep), group,
                                                   n_t),
                                _heads_from_shards(_expand(cvl, rep), group,
                                                   n_t),
                                cache_len + t, pad_len=padl)
        o_pl = [Shard(2) if i in tdims else p for i, p in enumerate(b_pl)]
        return DTensor.from_local(out, mesh, o_pl, run_check=False)
    out = seq_parallel(local(q, mesh, kv_pl), [ckl], [cvl], [lo],
                       cache_len + t, padl,
                       lambda parts, op: _all_reduce(parts[0], mesh, tdims,
                                                     op))
    return DTensor.from_local(out, mesh, b_pl, run_check=False)


# ---------------------------------------------------------------------------
# sequence-parallel attention, shared by the mesh and :func:`decode_shards`
# ---------------------------------------------------------------------------


def seq_parallel(q: torch.Tensor, cks: List[torch.Tensor],
                 cvs: List[torch.Tensor], los: List[int], valid_len: int,
                 pad_len, reducer: Callable) -> torch.Tensor:
    """Attention of ``q`` (B, H, t, d) over the T-shards of a cache that
    this process holds (``cks[i]`` / ``cvs[i]``, (B, Hkv, n_i, d), from
    position ``los[i]``): each shard's masked float32 scores, then the
    row max, the exponentials' sum and the partial ``p @ v`` (in the
    values' dtype), each combined across all the cache's shards by
    ``reducer(parts, op)`` (``parts`` one tensor a shard held here,
    ``op`` a ``ReduceOp``).  On a mesh a rank holds one shard and the
    reducer all-reduces it; shard by shard in one process it folds the
    parts in shard order (:func:`in_order`).  Returns (B, t, H, d)."""
    s = [_shard_scores(q, ck, lo, valid_len, pad_len)
         for ck, lo in zip(cks, los)]
    m = reducer([si.amax(-1, keepdim=True) for si in s], dist.ReduceOp.MAX)
    p = [torch.exp(si - m) for si in s]
    total = reducer([pi.sum(-1, keepdim=True) for pi in p],
                    dist.ReduceOp.SUM)
    out = reducer([_shard_context(pi / total, cv) for pi, cv in zip(p, cvs)],
                  dist.ReduceOp.SUM)
    return out.transpose(1, 2)


def in_order(parts: List[torch.Tensor], op) -> torch.Tensor:
    """A :func:`seq_parallel` reducer over the shards held in this
    process: the parts' max or sum, folded in shard order."""
    out = parts[0]
    for part in parts[1:]:
        out = (torch.maximum(out, part) if op == dist.ReduceOp.MAX
               else out + part)
    return out


def _expand(c: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: repeat each K/V head for its ``rep`` query heads.  A DTensor
    sharded on heads (whole heads a shard) repeats its local heads: the
    expansion's shards are the shards' expansions, and DTensor's own
    rule refuses a head dimension of one on an axis of one."""
    if rep == 1:
        return c
    if is_dtensor(c) and any(p.is_shard(1) for p in c.placements):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(c.to_local().repeat_interleave(rep, dim=1),
                                  c.device_mesh, c.placements,
                                  run_check=False)
    return c.repeat_interleave(rep, dim=1)


def _shard_write(c: torch.Tensor, new: torch.Tensor, cache_len: int,
                 lo: int) -> None:
    """Write the positions ``[cache_len, cache_len + t)`` of ``new`` (B,
    Hkv, t, d) that fall in the cache shard ``c`` (B, Hkv, n, d), which
    starts at position ``lo``, in place."""
    t, n = new.shape[2], c.shape[2]
    a, e = max(cache_len, lo), min(cache_len + t, lo + n)
    if a < e:
        c[:, :, a - lo:e - lo] = new[:, :, a - cache_len:e - cache_len].to(
            c.dtype)


def _shard_scores(q: torch.Tensor, ck: torch.Tensor, lo: int,
                  valid_len: int, pad_len) -> torch.Tensor:
    """The masked float32 scores of all query heads (B, H, t, d) against
    the cache shard ``ck`` (B, Hkv, n, d) that starts at ``lo``."""
    k_pos = lo + torch.arange(ck.shape[2], device=q.device)
    return _attend(q, _expand(ck, q.shape[1] // ck.shape[1]), k_pos,
                   valid_len, pad_len)


def _shard_context(p: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """A shard's part of ``softmax @ V``: its normalised probabilities
    (B, H, t, n), rounded to the values' dtype, times its values (the
    parts sum across the shards)."""
    cve = _expand(cv, p.shape[1] // cv.shape[1])
    return p.to(cve.dtype) @ cve


def decode_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor, n_shards: int, *,
                  cache_len: int, pad_len=None) -> torch.Tensor:
    """The sequence-parallel layout of :func:`_sharded_cache_attention`
    with ``n_shards`` T-shards, run shard by shard in this process (for a
    device that holds no process group of ``n_shards`` ranks, as
    :func:`repro_torch.models.moe.run_shards` runs the MoE's): each
    shard writes its positions of the new keys and values into its slice
    of the plain caches ``ck`` / ``cv`` (B, Hkv, Tmax, d), in place, and
    :func:`seq_parallel` combines the slices in shard order.  Returns
    (B, t, H, d)."""
    n = ck.shape[2] // n_shards
    los = list(range(0, n * n_shards, n))
    cks = [ck[:, :, lo:lo + n] for lo in los]
    cvs = [cv[:, :, lo:lo + n] for lo in los]
    for lo, cks_i, cvs_i in zip(los, cks, cvs):
        _shard_write(cks_i, k, cache_len, lo)
        _shard_write(cvs_i, v, cache_len, lo)
    return seq_parallel(q, cks, cvs, los, cache_len + q.shape[2], pad_len,
                        in_order)


def gqa_decode_shards(params: Dict, x: torch.Tensor, *, n_heads: int,
                      n_kv_heads: int, head_dim: int, theta: float,
                      kv_cache: Tuple, cache_len: int, n_shards: int,
                      pad_len: Optional[torch.Tensor] = None):
    """:func:`gqa_attention` with a plain cache, its attention run as
    ``n_shards`` T-shards shard by shard (:func:`decode_shards`).
    Returns (out, kv_cache)."""
    b, t, _ = x.shape
    q, k, v = _self_qkv(params, x, n_heads, n_kv_heads, head_dim, theta,
                        cache_len, pad_len)
    ck, cv = kv_cache
    out = decode_shards(q, k, v, ck, cv, n_shards, cache_len=cache_len,
                        pad_len=pad_len)
    return out.reshape(b, t, n_heads * head_dim) @ params["wo"], (ck, cv)


def _shards_from_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`_heads_from_shards`: ``x`` (B, H/n, T, d),
    all of T for this rank's heads, becomes (B, H, T/n, d), every head of
    this rank's T-block, by one all-to-all over ``group``."""
    b, h, tt, d = x.shape
    src = x.reshape(b, h, n, tt // n, d).permute(2, 0, 1, 3, 4).contiguous()
    dst = torch.empty_like(src)                # T-block j to rank j
    dist.all_to_all_single(dst, src, group=group)
    # block i of dst: rank i's heads of this rank's T-block
    return dst.permute(1, 0, 2, 3, 4).reshape(b, n * h, tt // n, d)


def _all_reduce(t: torch.Tensor, mesh, dims: List[int],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` in place over the mesh dimensions ``dims``."""
    for i in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


def _heads_from_shards(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """One all-to-all over ``group`` (``n`` ranks, rank ``i`` holding T
    block ``i``): ``x`` (B, H, T/n, d), every head of this rank's
    T-block, becomes (B, H/n, T, d), all of T for this rank's heads."""
    b, h, tl, d = x.shape
    src = x.transpose(0, 1).contiguous()       # head block j to rank j
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=group)
    # block i of dst: rank i's T-block of this rank's heads
    return dst.view(n, h // n, b, tl, d).permute(2, 1, 0, 3, 4).reshape(
        b, h // n, n * tl, d)
