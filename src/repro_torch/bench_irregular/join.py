"""join — hash join + group-by aggregate, expressed in the frontend.

The second frontend-opened workload family: two sequential top-level
loops (the classic build/probe phases) sharing one decoupled hash
table.  Values are strictly positive, so an empty bucket reads 0 and
the probe hit-test is a value check on a decoupled load — control LoD
again, with the miss rate set by the R/S key overlap:

    for i in range(NR):                 # build: accumulate R into HT
        HT[rkey[i]] += rval[i]
    for j in range(NS):                 # probe + group-by aggregate
        hv = HT[skey[j]]
        if hv != 0:                     # probe hit?
            G[sgrp[j]] += hv * sval[j]

Both phases carry an associative ``+`` store-update chain (``HT`` in
build, ``G`` in probe) — the segmented-scan forwarding shape — and both
loops are iteration-uniform, so the vectorised CU runs the whole kernel
as epoch batches.  ``miss_rate`` draws that fraction of S keys from a
key range R never writes.
"""
from __future__ import annotations

import numpy as np

from ..frontend import dae


def program(n_r: int = 24, n_s: int = 32, n_buckets: int = 48,
            n_groups: int = 8):
    """The recorded frontend program alone (re-record per compile — a
    ``Program`` is single-shot; the cache benchmark leans on this)."""
    p = dae("join", arrays={"HT": n_buckets, "G": n_groups, "rkey": n_r,
                            "rval": n_r, "skey": n_s, "sval": n_s,
                            "sgrp": n_s})
    with p.range_loop("i", p.const(n_r, "NR")):
        p.load("k", "rkey", "i")
        p.load("rv", "rval", "i")
        p.update("HT", "k", "rv", load="h0", dest="h1")
    with p.range_loop("j", p.const(n_s, "NS")):
        p.load("k2", "skey", "j")
        p.load("hv", "HT", "k2")
        p.bin("hit", "!=", "hv", "zero")
        with p.cond("hit", then="hit_b"):
            p.load("sv", "sval", "j")
            p.bin("w", "*", "hv", "sv")
            p.load("gi", "sgrp", "j")
            p.update("G", "gi", "w", load="g0", dest="g1")
    return p


def build(n_r: int = 24, n_s: int = 32, n_buckets: int = 48,
          n_groups: int = 8, miss_rate: float = 0.3, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    # R keys live in [0, n_buckets//2); misses probe [n_buckets//2, n_buckets)
    lo = n_buckets // 2
    rkey = rng.integers(0, lo, n_r).astype(np.int64)
    skey = rng.integers(0, lo, n_s).astype(np.int64)
    miss = rng.random(n_s) < miss_rate
    skey[miss] = rng.integers(lo, n_buckets, int(miss.sum()))
    p = program(n_r, n_s, n_buckets, n_groups)

    mem = {"HT": np.zeros(n_buckets, dtype=np.int64),
           "G": np.zeros(n_groups, dtype=np.int64),
           "rkey": rkey, "rval": rng.integers(1, 9, n_r).astype(np.int64),
           "skey": skey, "sval": rng.integers(1, 9, n_s).astype(np.int64),
           "sgrp": rng.integers(0, n_groups, n_s).astype(np.int64)}
    return BenchCase("join", p.build(), mem, {"HT", "G"},
                     note=f"NR={n_r} NS={n_s} buckets={n_buckets} "
                          f"miss_rate={miss_rate}")
