"""Model builder for the dense and moe families.

The counterpart of the JAX package's ``models/model.py``.  A config
compiles to a repeating layer group:

=========  ==========================
family     group pattern
=========  ==========================
dense      [attn, mlp]  x n_layers
moe        [attn, moe]  x n_layers
=========  ==========================

A Python loop over the groups takes the place of ``lax.scan``; the
parameters of group ``g`` are ``params["groups"][g]``, a dictionary with
one entry per sublayer (``s0_attn``, ``s1_moe``, ...), the reference's
names.  KV caches are a list over groups of one ``(k, v)`` pair per
attention sublayer, ``(B, Hkv, max_len, hd)`` each, written in place.

:func:`group_pattern` and :func:`group_count` keep every family of the
reference; building parameters or running a ``rwkv``, ``mamba`` or
``cross`` sublayer, or the enc-dec encoder, raises
:class:`NotImplementedError` naming the ROADMAP item that brings it.
Training (``loss``) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import layers as L
from . import moe as moe_mod

#: elements drawn per ``torch.randn`` call at init: a draw is made in
#: float32 before its cast, so the largest tensors (Kimi-K2's experts,
#: 5.6e9 elements each) are drawn in slices of at most this many
INIT_SLICE = 1 << 25

#: ROADMAP.md §1 items, by title, that bring the missing families
SSM_ITEM = "ROADMAP §1, 'RWKV-6 and Mamba: the ssm and hybrid families'"
CROSS_ITEM = ("ROADMAP §1, 'Cross-attention and enc-dec: the vlm and "
              "encdec families'")

_MISSING = {
    "rwkv": f"RWKV-6 sublayers (repro.models.ssm) are not ported yet: "
            f"{SSM_ITEM}",
    "mamba": f"Mamba sublayers (repro.models.ssm) are not ported yet: "
             f"{SSM_ITEM}",
    "cross": f"cross-attention sublayers are not ported yet: {CROSS_ITEM}",
    "encoder": f"the enc-dec encoder is not ported yet: {CROSS_ITEM}",
}


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(_MISSING[kind])


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
        None): matrices normal x 0.02 (drawn in float32, cast to the
        config's dtype), norms 1.  The distributions of the reference's
        init; its ``jax.random`` bits are not reproduced."""
        cfg = self.cfg
        device = torch.device(device if device is not None
                              else generator.device)
        dt = cfg.torch_dtype
        d, v = cfg.d_model, cfg.vocab

        def norm(shape):
            return torch.ones(shape, dtype=dt, device=device)

        def dense(shape, scale=0.02):
            out = torch.empty(shape, dtype=dt, device=device)
            rows = out.view(shape[0], -1)
            step = max(1, INIT_SLICE // max(1, rows.shape[1]))
            for lo in range(0, shape[0], step):
                part = rows[lo:lo + step]
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=device,
                                       dtype=torch.float32).mul_(scale))
            return out

        def sublayer_params(kind):
            hd = cfg.hd
            if kind == "attn":
                return {
                    "ln": norm((d,)),
                    "wq": dense((d, cfg.n_heads * hd)),
                    "wk": dense((d, cfg.n_kv_heads * hd)),
                    "wv": dense((d, cfg.n_kv_heads * hd)),
                    "wo": dense((cfg.n_heads * hd, d)),
                }
            if kind == "mlp":
                return {
                    "ln": norm((d,)),
                    "w_gate": dense((d, cfg.d_ff)),
                    "w_up": dense((d, cfg.d_ff)),
                    "w_down": dense((cfg.d_ff, d)),
                }
            if kind == "moe":
                ff = cfg.moe_d_ff or cfg.d_ff
                p = {
                    "ln": norm((d,)),
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
            raise _not_ported(kind) if kind in _MISSING else ValueError(kind)

        if cfg.n_enc_layers:
            raise _not_ported("encoder")
        pattern = group_pattern(cfg)
        params = {"embed": dense((v, d)), "ln_f": norm((d,))}
        params["groups"] = [
            {f"s{j}_{kind}": sublayer_params(kind)
             for j, kind in enumerate(pattern)}
            for _ in range(group_count(cfg))]
        params["lm_head"] = dense((d, v))
        return params

    # -------------------------------------------------------------- forward
    def _sublayer(self, kind: str, p: Dict, x: torch.Tensor, *,
                  pos_offset: int = 0, kv_cache=None, cache_len: int = 0,
                  pad_lens=None, moe_stats: bool = False):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln"])
        new_cache = None
        poison = None
        if kind == "attn":
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
        elif kind in _MISSING:
            raise _not_ported(kind)
        else:
            raise ValueError(kind)
        return x + out, new_cache, poison

    def _run_groups(self, params: Dict, x: torch.Tensor, *,
                    pos_offset: int = 0, caches=None, cache_len: int = 0,
                    pad_lens=None, collect_stats: bool = False):
        """Run every layer group in order.  ``caches``: the list of
        :meth:`init_cache`, updated in place.  ``pad_lens`` ((B,) int32,
        left-pad length per row) reaches every attention sublayer.
        Returns ``(x, caches)``, plus the summed MoE poison count (an
        int32 scalar tensor) with ``collect_stats``."""
        pattern = group_pattern(self.cfg)
        poison = torch.zeros((), dtype=torch.int32, device=x.device)
        for g, gp in enumerate(params["groups"]):
            a = 0
            for j, kind in enumerate(pattern):
                kv = None
                if kind == "attn" and caches is not None:
                    kv = caches[g][a]
                x, nkv, pois = self._sublayer(
                    kind, gp[f"s{j}_{kind}"], x, pos_offset=pos_offset,
                    kv_cache=kv, cache_len=cache_len, pad_lens=pad_lens,
                    moe_stats=collect_stats and kind == "moe")
                if kv is not None:
                    caches[g][a] = nkv
                    a += 1
                if pois is not None:
                    poison = poison + pois
        if collect_stats:
            return x, caches, poison
        return x, caches

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int,
                   device=None) -> Tuple[Optional[List], None]:
        """Zeroed KV caches: ``(caches, None)``, the second slot being the
        reference's SSM states, which the dense and moe families lack."""
        cfg = self.cfg
        pattern = group_pattern(cfg)
        for kind in pattern:
            if kind in _MISSING:
                raise _not_ported(kind)
        shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
        caches = [[(torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                    torch.zeros(shape, dtype=cfg.torch_dtype, device=device))
                   for kind in pattern if kind == "attn"]
                  for _ in range(group_count(cfg))]
        return (caches or None, None)

    def _head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """Logits of the last position, ``(B, vocab)``."""
        x = L.rms_norm(x[:, -1:], params["ln_f"])
        return (x @ params["lm_head"])[:, -1]

    def decode_step(self, params: Dict, cache, tokens: torch.Tensor,
                    cache_len: int, memory=None, *, pad_lens=None,
                    return_stats: bool = False):
        """One-token step: tokens (B, 1); cache from :meth:`init_cache` or
        :meth:`prefill`, updated in place and returned.

        ``pad_lens`` ((B,) int32): per-row left-pad length, masked out of
        attention, with RoPE positions counting real tokens only.
        ``return_stats=True`` appends ``{"moe_poison": n}`` (poisoned MoE
        dispatch requests this step, an int32 scalar tensor)."""
        if memory is not None:
            raise _not_ported("cross")
        caches, states = cache
        x = params["embed"][tokens.long()]
        res = self._run_groups(params, x, pos_offset=cache_len,
                               caches=caches, cache_len=cache_len,
                               pad_lens=pad_lens,
                               collect_stats=return_stats)
        logits = self._head(params, res[0])
        if return_stats:
            return logits, (res[1], states), {"moe_poison": res[2]}
        return logits, (res[1], states)

    def prefill(self, params: Dict, tokens: torch.Tensor, max_len: int,
                memory=None, *, pad_lens=None,
                return_stats: bool = False):
        """Fill a fresh cache with a whole prompt; returns the last
        position's logits and the cache.  See :meth:`decode_step` for
        ``pad_lens`` / ``return_stats``."""
        if memory is not None:
            raise _not_ported("cross")
        b, _ = tokens.shape
        caches, states = self.init_cache(b, max_len,
                                         device=params["embed"].device)
        x = params["embed"][tokens.long()]
        res = self._run_groups(params, x, pos_offset=0, caches=caches,
                               cache_len=0, pad_lens=pad_lens,
                               collect_stats=return_stats)
        logits = self._head(params, res[0])
        if return_stats:
            return logits, (res[1], states), {"moe_poison": res[2]}
        return logits, (res[1], states)


# ---------------------------------------------------------------------------
# layer-group schedules (every family of the reference)
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
