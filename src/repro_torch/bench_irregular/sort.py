"""sort — bitonic mergesort (§8.1.2, size 64), frontend-authored.

The bitonic network's compare-exchange pairs (lo, hi, dir) are precomputed
into read-only arrays (the network is static); the kernel walks them:

    for t in range(P):
        x = a[lo[t]]; y = a[hi[t]]
        if (x > y) == dir[t]:
            a[lo[t]] = y; a[hi[t]] = x

Formerly hand-rolled block wiring; now composed through
``repro.frontend`` (PR 9) — ``tests/test_frontend.py`` pins the lowered
IR byte-identical to the original hand-rolled layout.
"""
from __future__ import annotations

import numpy as np

from ..frontend import dae


def _bitonic_pairs(n: int):
    pairs = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            for i in range(n):
                l = i ^ j
                if l > i:
                    asc = (i & k) == 0
                    pairs.append((i, l, 1 if asc else 0))
            j //= 2
        k *= 2
    return pairs


def build(n: int = 64, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    pairs = _bitonic_pairs(n)
    P = len(pairs)

    p = dae("sort", arrays={"a": n, "lo": P, "hi": P, "dir": P})
    with p.range_loop("t", p.const(P, "P")):
        p.load("il", "lo", "t")
        p.load("ih", "hi", "t")
        p.load("x", "a", "il")
        p.load("y", "a", "ih")
        p.load("dd", "dir", "t")
        p.bin("gt", ">", "x", "y")
        p.bin("p", "==", "gt", "dd")
        with p.cond("p", then="swap"):
            p.store("a", "il", "y")
            p.store("a", "ih", "x")

    mem = {
        "a": rng.integers(0, 1000, n).astype(np.int64),
        "lo": np.array([p[0] for p in pairs], dtype=np.int64),
        "hi": np.array([p[1] for p in pairs], dtype=np.int64),
        "dir": np.array([p[2] for p in pairs], dtype=np.int64),
    }
    return BenchCase("sort", p.build(), mem, {"a"}, note=f"n={n} pairs={P}")
