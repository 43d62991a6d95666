"""hist — histogram with saturation, the paper's Fig.-1b shape (§8.1.2).

    for i in range(N):
        b = bins[i]
        h = H[b]
        if h < MAX:
            H[b] = h + w[i]

The branch reads a decoupled load (H[b]); the store to H is control-dependent
on it — a textbook control LoD.  ``true_rate`` instruments the data so the
branch (and hence the mis-speculation rate) is tunable for Table 2.
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function, LoopNest


def build(n: int = 256, n_bins: int = 32, max_count: int = 1 << 30,
          true_rate: float = 0.98, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    f = Function("hist")
    f.array("H", n_bins)
    f.array("bins", n)
    f.array("w", n)

    nest = LoopNest(f)
    b = nest.enter("i", nest.const(n, "N"))
    b.load("b", "bins", "i")
    b.load("hv", "H", "b")
    b.bin("p", "<", "hv", nest.const(max_count, "MAX"))
    b.cbr("p", "then", nest.latch)
    t = f.block("then")
    t.load("wv", "w", "i")
    t.bin("h1", "+", "hv", "wv")
    t.store("H", "b", "h1")
    t.br(nest.latch)
    nest.finish()

    # true_rate controls how often the branch is taken: saturate a fraction
    # of bins at MAX so their updates mis-speculate.
    hot = rng.random(n_bins) >= true_rate
    H0 = np.where(hot, max_count, 0).astype(np.int64)
    mem = {
        "H": H0,
        "bins": rng.integers(0, n_bins, n).astype(np.int64),
        "w": rng.integers(1, 5, n).astype(np.int64),
    }
    return BenchCase("hist", f, mem, {"H"},
                     note=f"N={n} bins={n_bins} true_rate={true_rate}")
