"""Weights of a cell, drawn from ``--seed`` on the device.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference.  The layout is the one the port's
``Model`` reads: ``embed`` (V, d), ``ln_f`` (d,), ``lm_head`` (d, V) and
``groups``, a list over layer groups of one dictionary per sublayer
(``s{j}_{kind}``).  Matrices are normal x 0.02, norms 1: the
distributions of the port's own init.  Every
matrix is a view of one buffer in the served dtype, allocated once and
drawn by one ``normal_`` call on the device, so set-up draws ~20e9
parameters in one allocation and one kernel.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def group_pattern(port: Dict) -> Tuple[str, ...]:
    """The sublayer kinds of one layer group, in order (a frozen copy of
    the port's schedule for the family the benchmark runs)."""
    if port["family"] == "moe":
        return ("attn", "moe")
    raise ValueError(f"the benchmark has no schedule for family "
                     f"{port['family']}")


def group_count(port: Dict) -> int:
    """Layer groups in the configuration."""
    return port["n_layers"]


def head_dim(port: Dict) -> int:
    """Width of one attention head."""
    return port.get("head_dim") or port["d_model"] // port["n_heads"]


def draw_params(port: Dict, generator: torch.Generator, device) -> Dict:
    """Every weight of the configuration ``port`` (the ``port`` object of
    a configuration file)."""
    dt = getattr(torch, port["dtype"])
    sizes: List[int] = []

    def count(kind, *shape):
        if kind == "normal":
            sizes.append(_aligned(shape))
    _tree(port, count)
    flat = torch.empty((sum(sizes),), dtype=dt, device=device)
    flat.normal_(0.0, 0.02, generator=generator)
    at = 0

    def make(kind, *shape):
        nonlocal at
        if kind == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        out = flat[at:at + math.prod(shape)].view(shape)
        at += _aligned(shape)
        return out
    return _tree(port, make)


#: every matrix starts at a multiple of this many elements in the buffer
ALIGN = 256


def _aligned(shape) -> int:
    return -(-math.prod(shape) // ALIGN) * ALIGN


def _tree(port: Dict, make) -> Dict:
    """The weights' layout, each tensor made by ``make(kind, *shape)``:
    ``normal`` matrices, ``ones`` norms."""
    d, v, hd = port["d_model"], port["vocab"], head_dim(port)

    def dense(*shape):
        return make("normal", *shape)

    def ones(n):
        return make("ones", n)

    def sublayer(kind: str):
        if kind == "attn":
            return {"ln": ones(d), "wq": dense(d, port["n_heads"] * hd),
                    "wk": dense(d, port["n_kv_heads"] * hd),
                    "wv": dense(d, port["n_kv_heads"] * hd),
                    "wo": dense(port["n_heads"] * hd, d)}
        if kind == "moe":
            e = port["n_experts"]
            ff = port.get("moe_d_ff") or port["d_ff"]
            p = {"ln": ones(d), "router": dense(d, e),
                 "w_gate": dense(e, d, ff), "w_up": dense(e, d, ff),
                 "w_down": dense(e, ff, d)}
            if port.get("n_shared_experts"):
                sf = ff * port["n_shared_experts"]
                p.update(shared_w_gate=dense(d, sf), shared_w_up=dense(d, sf),
                         shared_w_down=dense(sf, d))
            return p
        raise ValueError(kind)

    params = {"embed": dense(v, d), "ln_f": ones(d)}
    params["groups"] = [{f"s{j}_{kind}": sublayer(kind)
                         for j, kind in enumerate(group_pattern(port))}
                        for _ in range(group_count(port))]
    params["lm_head"] = dense(d, v)
    return params


def count_params(params) -> int:
    """Parameters held."""
    if isinstance(params, dict):
        return sum(count_params(x) for x in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(x) for x in params)
    return params.numel()
