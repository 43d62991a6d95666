"""Model builder: one code path for every family of the reference.

The counterpart of the JAX package's ``models/model.py``.  A config
compiles to a repeating layer group:

=========  ==================================================
family     group pattern
=========  ==================================================
dense      [attn, mlp]                        x n_layers
moe        [attn, moe]                        x n_layers
ssm        [rwkv6, mlp]                       x n_layers
hybrid     [(mamba, mlp/moe)x7, (attn, moe)]  x n_layers/8
vlm        [(attn, mlp)x4, (cross, mlp)]      x n_layers/5
encdec     encoder [attn, mlp]xE  +  decoder [self, cross, mlp]xL
=========  ==================================================

A Python loop over the groups takes the place of ``lax.scan``; the
parameters of group ``g`` are ``params["groups"][g]``, a dictionary with
one entry per sublayer (``s0_attn``, ``s1_moe``, ...), the reference's
names; the enc-dec encoder's are ``params["enc_groups"][i]``.  The cache
is ``(caches, states)``: KV caches are a list over groups of one
``(k, v)`` pair per attention sublayer, ``(B, Hkv, max_len, hd)`` each,
written in place; SSM states a list over groups of one state per rwkv or
mamba sublayer, replaced by each call.  Either is None when the pattern
has no such sublayer.  Cross-attention reads ``memory`` (stub patch or
frame embeddings, ``(B, S, d_model)``) through its own K/V projections
on every call.

:meth:`Model.loss` is the training objective: the mean next-token NLL
from float32 log-softmax, over every family.  Each layer group, and each
encoder layer, runs under ``torch.utils.checkpoint`` (non-reentrant):
its activations are recomputed in the backward pass, as the reference
remats each scanned group with ``nothing_saveable``; a step keeps only
each group's input.  The serving calls never checkpoint.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..configs.base import ArchConfig
from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod
from .sharding import SumAcross, local, shard_span

#: elements drawn per ``torch.randn`` call at init: a draw is made in
#: float32 before its cast, so the largest tensors (Kimi-K2's experts,
#: 5.6e9 elements each) are drawn in slices of at most this many
INIT_SLICE = 1 << 25

#: sublayer kinds that carry a recurrent state
SSM_KINDS = ("rwkv", "mamba")


def draw_dense(shape, generator, device, dtype,
               scale=0.02) -> torch.Tensor:
    """Normal x ``scale``, drawn in float32 slices of at most
    :data:`INIT_SLICE` elements, cast to ``dtype``.  On the meta device
    (shapes and dtypes only, as the dry run and the sharding rules take
    them) nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    rows = out.view(shape[0], -1)
    step = max(1, INIT_SLICE // max(1, rows.shape[1]))
    for lo in range(0, shape[0], step):
        part = rows[lo:lo + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=device,
                               dtype=torch.float32).mul_(scale))
    return out


def init_sublayer(cfg: ArchConfig, kind: str, generator: torch.Generator,
                  device) -> Dict:
    """One sublayer's random parameters, the reference's shapes, dtypes
    and distributions: matrices normal x 0.02 (``ww`` x 0.01), norms 1,
    RWKV's ``mu`` 0.5 and ``w_bias`` 2.0, Mamba's ``a_log`` float32
    zeros whatever the config's dtype."""
    d, hd, dt = cfg.d_model, cfg.hd, cfg.torch_dtype

    def dense(shape, scale=0.02):
        return draw_dense(shape, generator, device, dt, scale)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    if kind in ("attn", "cross"):
        return {
            "ln": full((d,), 1.0),
            "wq": dense((d, cfg.n_heads * hd)),
            "wk": dense((d, cfg.n_kv_heads * hd)),
            "wv": dense((d, cfg.n_kv_heads * hd)),
            "wo": dense((cfg.n_heads * hd, d)),
        }
    if kind == "mlp":
        return {
            "ln": full((d,), 1.0),
            "w_gate": dense((d, cfg.d_ff)),
            "w_up": dense((d, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, d)),
        }
    if kind == "moe":
        ff = cfg.moe_d_ff or cfg.d_ff
        p = {
            "ln": full((d,), 1.0),
            "router": dense((d, cfg.n_experts)),
            "w_gate": dense((cfg.n_experts, d, ff)),
            "w_up": dense((cfg.n_experts, d, ff)),
            "w_down": dense((cfg.n_experts, ff, d)),
        }
        if cfg.n_shared_experts:
            sf = ff * cfg.n_shared_experts
            p.update(shared_w_gate=dense((d, sf)),
                     shared_w_up=dense((d, sf)),
                     shared_w_down=dense((sf, d)))
        return p
    if kind == "rwkv":
        return {
            "ln": full((d,), 1.0),
            "mu": full((4, d), 0.5),
            "wr": dense((d, d)),
            "wk": dense((d, d)),
            "wv": dense((d, d)),
            "ww": dense((d, d), 0.01),
            "w_bias": full((d,), 2.0),
            "u": dense((d,)),
            "wo": dense((d, d)),
        }
    if kind == "mamba":
        n = cfg.ssm_d_state
        return {
            "ln": full((d,), 1.0),
            "in_proj": dense((d, d)),
            "gate_proj": dense((d, d)),
            "dt_proj": dense((d,)),
            "b_proj": dense((d, n)),
            "c_proj": dense((d, n)),
            "a_log": full((d, n), 0.0, torch.float32),
            "out_proj": dense((d, d)),
        }
    raise ValueError(kind)


class Model(NamedTuple):
    cfg: ArchConfig
    # "spec" (speculative dispatch, masked index_add reference) |
    # "spec-kernel" (the same dispatch through spec_scatter_add /
    # spec_gather) | "dense" (if-converted baseline)
    dispatch: str

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator,
             device=None) -> Dict:
        """Random parameters on ``device`` (the generator's device when
        None), each sublayer by :func:`init_sublayer`.  The distributions
        of the reference's init; its ``jax.random`` bits are not
        reproduced."""
        cfg = self.cfg
        device = torch.device(device if device is not None
                              else generator.device)
        dt = cfg.torch_dtype
        d, v = cfg.d_model, cfg.vocab

        def draw(kind):
            return init_sublayer(cfg, kind, generator, device)

        pattern = group_pattern(cfg)
        params = {"embed": draw_dense((v, d), generator, device, dt),
                  "ln_f": torch.ones((d,), dtype=dt, device=device)}
        params["groups"] = [
            {f"s{j}_{kind}": draw(kind) for j, kind in enumerate(pattern)}
            for _ in range(group_count(cfg))]
        params["lm_head"] = draw_dense((d, v), generator, device, dt)
        if cfg.n_enc_layers:
            params["enc_groups"] = [
                {"s0_attn": draw("attn"), "s1_mlp": draw("mlp")}
                for _ in range(cfg.n_enc_layers)]
            params["enc_ln_f"] = torch.ones((d,), dtype=dt, device=device)
        return params

    # -------------------------------------------------------------- forward
    def _sublayer(self, kind: str, p: Dict, x: torch.Tensor, *,
                  pos_offset: int = 0, cross_kv=None, kv_cache=None,
                  cache_len: int = 0, state=None, pad_lens=None,
                  moe_stats: bool = False):
        cfg = self.cfg
        sp = spans.ON and kind == "attn" and spans.open("model.attn",
                                                        mark=True)
        # the sublayer's input stays replicated over ``model``: its
        # gradient, a partial sum of the tensor-parallel products, is
        # all-reduced here (the reference's constraint on the cotangent)
        h = L.constrain(L.rms_norm(x, p["ln"]), "dp", None, None)
        new_cache = new_state = poison = None
        if kind == "cross":
            # project the memory with this sublayer's K/V weights, on every
            # call (the reference recomputes them per decode step too)
            if cross_kv is None:
                raise ValueError(f"{cfg.name}: a cross sublayer needs "
                                 "memory")
            kk, vv = (L.kv_heads(cross_kv, p[w], cfg.n_kv_heads,
                                 cfg.n_heads, cfg.hd) for w in ("wk", "wv"))
            out, _ = L.gqa_attention(
                p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, theta=cfg.rope_theta,
                cross_kv=(kk.to(h.dtype), vv.to(h.dtype)))
        elif kind == "attn":
            out, new_cache = L.gqa_attention(
                p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd, theta=cfg.rope_theta,
                pos_offset=pos_offset, kv_cache=kv_cache,
                cache_len=cache_len, pad_len=pad_lens)
        elif kind == "mlp":
            out = L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
        elif kind == "moe":
            b, t, d = h.shape
            if self.dispatch == "dense":
                res = moe_mod.moe_dense(
                    p, h.reshape(b * t, d), n_experts=cfg.n_experts,
                    top_k=cfg.top_k, stats=moe_stats)
            else:
                res = moe_mod.moe_spec(
                    p, h.reshape(b * t, d), n_experts=cfg.n_experts,
                    top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                    kernel=self.dispatch == "spec-kernel", stats=moe_stats)
            out, poison = res if moe_stats else (res, None)
            out = out.reshape(b, t, d)
        elif kind == "rwkv":
            # RWKV's heads are d_model / head_dim, not cfg.n_heads
            res = ssm_mod.rwkv6_block(p, h, n_heads=cfg.d_model // cfg.hd,
                                      head_dim=cfg.hd, state=state,
                                      return_state=state is not None)
            out, new_state = res if state is not None else (res, None)
        elif kind == "mamba":
            res = ssm_mod.mamba_block(p, h, d_state=cfg.ssm_d_state,
                                      state=state,
                                      return_state=state is not None)
            out, new_state = res if state is not None else (res, None)
        else:
            raise ValueError(kind)
        x = x + out
        if sp:
            spans.close(sp)
        return x, new_cache, new_state, poison

    def _run_groups(self, params: Dict, x: torch.Tensor, *,
                    pos_offset: int = 0, cross_kv=None, caches=None,
                    cache_len: int = 0, states=None, pad_lens=None,
                    collect_stats: bool = False):
        """Run every layer group in order.  ``caches`` / ``states``: the
        lists of :meth:`init_cache`, updated in place.  ``pad_lens`` ((B,)
        int32, left-pad length per row) reaches every attention sublayer
        (not the SSM states, as in the reference).  Returns ``(x, caches,
        states)``, plus the summed MoE poison count (an int32 scalar
        tensor) with ``collect_stats``."""
        pattern = group_pattern(self.cfg)
        poison = torch.zeros((), dtype=torch.int32, device=x.device)
        for g, gp in enumerate(params["groups"]):
            a = si = 0
            for j, kind in enumerate(pattern):
                kv = st = None
                if kind == "attn" and caches is not None:
                    kv = caches[g][a]
                if kind in SSM_KINDS and states is not None:
                    st = states[g][si]
                x, nkv, nst, pois = self._sublayer(
                    kind, gp[f"s{j}_{kind}"], x, pos_offset=pos_offset,
                    cross_kv=cross_kv, kv_cache=kv, cache_len=cache_len,
                    state=st, pad_lens=pad_lens,
                    moe_stats=collect_stats and kind == "moe")
                if kv is not None:
                    caches[g][a] = nkv
                    a += 1
                if st is not None:
                    states[g][si] = nst
                    si += 1
                if pois is not None:
                    poison = poison + pois
        if collect_stats:
            return x, caches, states, poison
        return x, caches, states

    def _enc_layer(self, gp: Dict, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        out, _ = L.gqa_attention(
            gp["s0_attn"], L.rms_norm(h, gp["s0_attn"]["ln"]),
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, theta=cfg.rope_theta, causal=False)
        h = h + out
        m = gp["s1_mlp"]
        return h + L.swiglu(L.rms_norm(h, m["ln"]), m["w_gate"], m["w_up"],
                            m["w_down"])

    def _encode(self, params: Dict, frames: torch.Tensor, *,
                remat: bool = False) -> torch.Tensor:
        """The enc-dec encoder over stub frame embeddings (bidirectional,
        no cache); ``remat`` checkpoints each layer (training)."""
        h = frames
        for gp in params["enc_groups"]:
            h = (checkpoint(self._enc_layer, gp, h, use_reentrant=False)
                 if remat else self._enc_layer(gp, h))
        return L.rms_norm(h, params["enc_ln_f"])

    def _make_cross(self, params: Dict, memory):
        """Cross-attention K/V are projected per sublayer from this memory
        (each cross sublayer owns its ``wk`` / ``wv``), so the memory goes
        through as it is."""
        return memory

    # ----------------------------------------------------------------- train
    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Mean NLL of the next token.  ``batch["tokens"]`` (B, T) int32;
        the enc-dec family also takes ``batch["frames"]`` and the vlm
        family ``batch["patches"]``, (B, S, d_model) stub memory."""
        cfg = self.cfg
        tokens = batch["tokens"].long()
        x = self._embed(params, tokens)
        cross = None
        if cfg.family == "encdec":
            cross = self._make_cross(params, self._encode(
                params, batch["frames"], remat=True))
        elif cfg.family == "vlm":
            cross = self._make_cross(params, batch["patches"])
        for gp in params["groups"]:
            x = checkpoint(lambda gp, x: self._run_groups(
                {"groups": [gp]}, x, cross_kv=cross)[0], gp, x,
                use_reentrant=False)
        # the head's input stays replicated over ``model``: its gradient,
        # partial over the vocabulary shards, is all-reduced once here
        x = L.constrain(L.rms_norm(x, params["ln_f"]), "dp", None, None)
        logits = (x @ L.weight(params["lm_head"]))[:, :-1].float()
        return _nll(logits, tokens[:, 1:]).mean()

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int,
                   device=None) -> Tuple[Optional[List], Optional[List]]:
        """Zeroed ``(caches, states)`` with the reference's shapes and
        dtypes: KV caches in the config's dtype; RWKV states ``(S, x_last)``
        with S (B, H, hd, hd) and the token-shift carry (B, d_model), Mamba
        states (B, d_model, d_state), all float32."""
        cfg = self.cfg
        pattern = group_pattern(cfg)
        shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        def state(kind):
            if kind == "rwkv":
                h = cfg.d_model // cfg.hd
                return (zeros((batch, h, cfg.hd, cfg.hd)),
                        zeros((batch, cfg.d_model)))
            return zeros((batch, cfg.d_model, cfg.ssm_d_state))

        n_groups = group_count(cfg)
        caches = states = None
        if "attn" in pattern:
            caches = [[(zeros(shape, cfg.torch_dtype),
                        zeros(shape, cfg.torch_dtype))
                       for kind in pattern if kind == "attn"]
                      for _ in range(n_groups)]
        if any(kind in SSM_KINDS for kind in pattern):
            states = [[state(kind) for kind in pattern if kind in SSM_KINDS]
                      for _ in range(n_groups)]
        return caches, states

    def _head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """Logits of the last position, ``(B, vocab)``."""
        sp = spans.ON and spans.open("model.head", mark=True)
        x = L.rms_norm(x[:, -1:], params["ln_f"])
        logits = (x @ L.weight(params["lm_head"]))[:, -1]
        if sp:
            spans.close(sp)
        return logits

    @staticmethod
    def _embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings: an embedding lookup (the rows a plain
        index reads).  On a DTensor table sharded on the vocabulary, each
        rank looks its tokens up in its own rows (zeros for a token held
        elsewhere) and the rows are summed across the shards once (no
        table all-gather); the local table's gradient is partial over the
        data axes, each rank's tokens being its own."""
        table = params["embed"]
        if not (hasattr(table, "placements") and any(
                p.is_shard(0) for p in table.placements)):
            return L.constrain(F.embedding(tokens.long(), table),
                               "dp", None, None)
        from torch.distributed.tensor import DTensor, Partial, Replicate
        table = L.weight(table)
        mesh = table.device_mesh
        lo, n, vdims = shard_span(table, 0)
        # the embeddings take the tokens' placements
        b_pl = (list(tokens.placements) if L.is_dtensor(tokens)
                else [Replicate()] * mesh.ndim)
        idx = local(tokens, mesh, b_pl).long() - lo
        hit = (idx >= 0) & (idx < n)
        grad_pl = [p if p.is_shard() else Partial()
                   for p in table.placements]
        rows = F.embedding(idx.clamp(0, n - 1),
                           table.to_local(grad_placements=grad_pl))
        rows = torch.where(hit[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        x = SumAcross.apply(rows, mesh, tuple(vdims))
        return DTensor.from_local(x, mesh, b_pl, run_check=False)

    def _forward(self, params: Dict, tokens: torch.Tensor, cache, pos: int,
                 memory, pad_lens, return_stats: bool):
        caches, states = cache
        x = self._embed(params, tokens)
        res = self._run_groups(params, x, pos_offset=pos, cross_kv=memory,
                               caches=caches, cache_len=pos, states=states,
                               pad_lens=pad_lens,
                               collect_stats=return_stats)
        logits = self._head(params, res[0])
        if return_stats:
            return logits, (res[1], res[2]), {"moe_poison": res[3]}
        return logits, (res[1], res[2])

    def decode_step(self, params: Dict, cache, tokens: torch.Tensor,
                    cache_len: int, memory=None, *, pad_lens=None,
                    return_stats: bool = False):
        """One-token step: tokens (B, 1); cache from :meth:`init_cache` or
        :meth:`prefill`, updated in place and returned.  ``memory`` reaches
        the cross sublayers as given (the enc-dec family's is not encoded
        here, as in the reference).

        ``pad_lens`` ((B,) int32): per-row left-pad length, masked out of
        attention, with RoPE positions counting real tokens only.
        ``return_stats=True`` appends ``{"moe_poison": n}`` (poisoned MoE
        dispatch requests this step, an int32 scalar tensor)."""
        sp = spans.ON and spans.open("model.decode_step", mark=True)
        out = self._forward(params, tokens, cache, cache_len,
                            self._make_cross(params, memory), pad_lens,
                            return_stats)
        if sp:
            spans.close(sp)
        return out

    def prefill(self, params: Dict, tokens: torch.Tensor, max_len: int,
                memory=None, *, pad_lens=None,
                return_stats: bool = False):
        """Fill a fresh cache with a whole prompt; returns the last
        position's logits and the cache.  The enc-dec family encodes
        ``memory`` (stub frames) first.  See :meth:`decode_step` for
        ``pad_lens`` / ``return_stats``."""
        sp = spans.ON and spans.open("model.prefill", mark=True)
        b, _ = tokens.shape
        cache = self.init_cache(b, max_len, device=params["embed"].device)
        if self.cfg.family == "encdec" and memory is not None:
            memory = self._encode(params, memory)
        out = self._forward(params, tokens, cache, 0,
                            self._make_cross(params, memory), pad_lens,
                            return_stats)
        if sp:
            spans.close(sp)
        return out


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The next-token NLL of each position, ``(B, T, 1)``, from float32
    ``logits`` (B, T, V) and ``labels`` (B, T).

    On a DTensor whose vocabulary is sharded (the dry run's and the
    reference's layout of the head), DTensor's ``log_softmax`` would
    gather the logits.  Here each rank works on its vocabulary shard, as
    the reference's partitioned softmax does: the row max and the
    exponentials' sum are reduced across the shards, and the label's
    logit is read on the shard that holds it and summed; one number a
    row crosses the mesh, and the logits stay sharded."""
    vdim = logits.ndim - 1
    if not (hasattr(logits, "placements") and any(
            p.is_shard(vdim) for p in logits.placements) and all(
            p.is_shard(0) or p.is_shard(vdim) for p in logits.placements)):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[..., None])
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = logits.device_mesh
    lo, n, vdims = shard_span(logits, vdim)
    b_pl = [Shard(0) if p.is_shard(0) else Replicate()
            for p in logits.placements]
    lg = logits.to_local()
    lab = local(labels, mesh, b_pl)[..., None].long() - lo
    m = lg.detach().amax(-1, keepdim=True)
    for i in vdims:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    z = lg - m
    hit = (lab >= 0) & (lab < n)
    tgt = torch.where(hit, torch.gather(z, -1, lab.clamp(0, n - 1)),
                      torch.zeros((), dtype=z.dtype, device=z.device))
    sums = SumAcross.apply(
        torch.cat([torch.exp(z).sum(-1, keepdim=True), tgt], dim=-1),
        mesh, tuple(vdims))
    nll = torch.log(sums[..., :1]) - sums[..., 1:]
    return DTensor.from_local(nll, mesh, b_pl, run_check=False)


# ---------------------------------------------------------------------------
# layer-group schedules
# ---------------------------------------------------------------------------


def group_pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.family == "dense":
        return ("attn", "mlp")
    if cfg.family == "moe":
        return ("attn", "moe")
    if cfg.family == "ssm":
        return ("rwkv", "mlp")
    if cfg.family == "hybrid":
        out = []
        stride = cfg.attn_stride
        for j in range(stride):
            out.append("attn" if j == stride - 1 else "mamba")
            out.append("moe" if (j % cfg.moe_every) == cfg.moe_every - 1
                       else "mlp")
        return tuple(out)
    if cfg.family == "vlm":
        out = []
        for j in range(cfg.cross_stride):
            out.append("cross" if j == cfg.cross_stride - 1 else "attn")
            out.append("mlp")
        return tuple(out)
    if cfg.family == "encdec":
        return ("attn", "cross", "mlp")   # decoder group
    raise ValueError(cfg.family)


def group_count(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.attn_stride == 0
        return cfg.n_layers // cfg.attn_stride
    if cfg.family == "vlm":
        assert cfg.n_layers % cfg.cross_stride == 0
        return cfg.n_layers // cfg.cross_stride
    return cfg.n_layers


def build_model(cfg: ArchConfig, dispatch: str = "spec") -> Model:
    return Model(cfg, dispatch)
