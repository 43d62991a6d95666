"""The benchmark's yardstick: peaks of one H100 and the work of a call.

Frozen: later changes to the program do not edit this file.  Peaks are
NVIDIA's data-sheet numbers for the H100 SXM (dense, no sparsity).  The
scan bound is a copy of ``chip_smoke.py``'s ``_scan_bytes`` and the
Mamba chunk route's exp bound; the MoE bound and the model-FLOP count
count what the inputs need, whatever implements them:

* MoE layer: bytes of the router, the shared expert and every expert at
  least one token routes to (the touched set, which the benchmark works
  out itself from the layer's input and router), plus the activations in
  and out; FLOPs of the router, the routed (token, expert) pairs and the
  shared expert.  Experts no token routes to are not counted, so a
  dispatch that skips them can reach 100% and no more.
* Model FLOPs of one token: 2 x the matmul parameters it meets (attention
  projections, the router, its top-k experts and the shared expert), plus
  4 x heads x head width x the live
  key positions it attends over (scores and context), plus the head's
  2 x d x V where the port computes logits.  Padding, a wave's dead rows
  and recompute are not counted.

The scan bound counts a Mamba scan of any width; no cell runs one yet
(the hybrid configuration waits for the port's Mamba block at its
published widths).
"""
from __future__ import annotations

from typing import Dict, Sequence

#: H100 SXM, dense: bf16 tensor cores, HBM3
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
#: exps a clock on each SM's special-function units (compute capability
#: 9.0) and the H100 SXM's SMs
SFU_EXP_PER_CLOCK, N_SM = 16, 132
#: the Mamba state width the copied scan bytes assume
SCAN_N = 16


def bf16_bound_s(flops: float, nbytes: float) -> float:
    """Least time of work bound by the bf16 peak or by HBM."""
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def moe_work(n_tokens: int, touched: int, *, d: int, n_experts: int,
             top_k: int, ff: int, shared_ff: int, elem: int = 2) -> Dict:
    """FLOPs and bytes one MoE call needs: ``n_tokens`` rows of width
    ``d`` in and out, a router of ``n_experts`` columns, ``touched``
    distinct experts of three ``d x ff`` matrices read, ``top_k`` routed
    pairs a token, and a shared expert of width ``shared_ff`` (0 for
    none)."""
    expert = 3 * d * ff
    shared = 3 * d * shared_ff
    flops = 2 * n_tokens * (d * n_experts + top_k * expert + shared)
    nbytes = elem * (d * n_experts + shared + touched * expert
                     + 2 * n_tokens * d)
    return {"flops": flops, "bytes": nbytes}


# ---------------------------------------------------------------------------
# the Mamba scan (copied from chip_smoke.py's _scan_bytes / _scan_bound)
# ---------------------------------------------------------------------------


def mamba_scan_bytes(b: int, t: int, width: int, elem: int = 2) -> int:
    """Bytes of one Mamba scan forward: u in and y out, delta, B and C in,
    A and the state in and out (float32)."""
    act, small = b * t * width * elem, b * t * (1 + 2 * SCAN_N) * elem
    a, state = width * SCAN_N * 4, b * width * SCAN_N * 4
    return 2 * act + small + a + 2 * state


def mamba_scan_bound_s(b: int, t: int, width: int, n: int, clock_hz: float,
                       elem: int = 2) -> float:
    """Least time of one Mamba scan forward: one exp a state element a
    step on the special-function units, or its bytes, the larger."""
    exps = b * t * width * n
    return max(exps / (SFU_EXP_PER_CLOCK * N_SM * clock_hz),
               mamba_scan_bytes(b, t, width, elem) / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


def token_matmul_params(port: Dict, pattern: Sequence[str]) -> int:
    """Matmul parameters one token meets in one layer group (without the
    head): the active parameters of the group."""
    d = port["d_model"]
    hd = port.get("head_dim") or d // port["n_heads"]
    ff = port.get("moe_d_ff") or port["d_ff"]
    total = 0
    for kind in pattern:
        if kind == "attn":
            total += d * hd * (2 * port["n_heads"] + 2 * port["n_kv_heads"])
        elif kind == "moe":
            total += d * port["n_experts"] + 3 * d * ff * (
                port["top_k"] + port.get("n_shared_experts", 0))
        else:
            raise ValueError(kind)
    return total


def attention_flops(port: Dict, pattern: Sequence[str], groups: int,
                    live_keys: int) -> int:
    """Scores and context of queries over ``live_keys`` (query, key)
    pairs in all, over every attention sublayer."""
    hd = port.get("head_dim") or port["d_model"] // port["n_heads"]
    n_attn = groups * sum(1 for k in pattern if k == "attn")
    return 4 * port["n_heads"] * hd * live_keys * n_attn


def model_flops(port: Dict, pattern: Sequence[str], groups: int, *,
                tokens: int, live_keys: int, head_rows: int) -> int:
    """Model FLOPs of ``tokens`` real tokens through every group, their
    attention over ``live_keys`` live (query, key) pairs, and the head at
    ``head_rows`` positions."""
    per_token = 2 * groups * token_matmul_params(port, pattern)
    head = 2 * port["d_model"] * port["vocab"]
    return (tokens * per_token + head_rows * head
            + attention_flops(port, pattern, groups, live_keys))


def causal_pairs(n: int) -> int:
    """Live (query, key) pairs of ``n`` queries at real positions 0 to
    ``n - 1``, each over the keys up to its own position."""
    return n * (n + 1) // 2

