"""pagerank — push-pull PageRank, expressed entirely in the frontend.

The first workload family the composable frontend (``repro.frontend``)
opens up: an outer iteration loop containing two *sequential sibling*
loops — a shape no hand-rolled bench used and the reason
``LoopNest`` grew the header-exit hand-off.  Fixed-point arithmetic
(scale ``SC``) keeps the kernel in the backends' int64 subset:

    for it in range(T):
        for e in range(E):                      # push (edge-centric)
            rv = R[src[e]]
            if rv > THRESH:                     # active-vertex gate
                C[dst[e]] += rv // deg[src[e]]
        for v in range(N):                      # pull (vertex-centric)
            R[v] = BASE + (C[v] * ALPHA_NUM) // ALPHA_DEN
            C[v] = 0

The gate reads a decoupled load (``R``) and the ``C`` update is
control-dependent on it — the paper's control LoD.  ``active_rate``
seeds a fraction of ranks below ``THRESH`` so the branch (and the
mis-speculation rate) is tunable like hist's ``true_rate``.
"""
from __future__ import annotations

import numpy as np

from ..frontend import dae

#: fixed-point scale and damping (0.85 ≈ 85/100), teleport base 0.15*SC
SC, BASE, ALPHA_NUM, ALPHA_DEN = 1024, 154, 85, 100


def program(n: int = 24, n_edges: int = 96, iters: int = 3,
            thresh: int = 64):
    """The recorded frontend program alone (a ``Program`` is single-shot,
    so callers that compile repeatedly — the cache benchmark — re-record
    through this factory)."""
    p = dae("pagerank", arrays={"R": n, "C": n, "src": n_edges,
                                "dst": n_edges, "deg": n})
    with p.range_loop("it", p.const(iters, "T")):
        with p.range_loop("e", p.const(n_edges, "E")):
            p.load("u", "src", "e")
            p.load("rv", "R", "u")
            p.bin("act", ">", "rv", p.const(thresh, "THRESH"))
            with p.cond("act", then="push"):
                p.load("dg", "deg", "u")
                p.bin("sh", "//", "rv", "dg")
                p.load("d", "dst", "e")
                p.update("C", "d", "sh", load="cv", dest="c1")
        with p.range_loop("v", p.const(n, "N")):
            p.load("cv2", "C", "v")
            p.bin("num", "*", "cv2", p.const(ALPHA_NUM, "AN"))
            p.bin("sc", "//", "num", p.const(ALPHA_DEN, "AD"))
            p.bin("r1", "+", p.const(BASE, "B"), "sc")
            p.store("R", "v", "r1")
            p.store("C", "v", "zero")
    return p


def build(n: int = 24, n_edges: int = 96, iters: int = 3,
          active_rate: float = 0.8, thresh: int = 64, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, n_edges).astype(np.int64)
    dst = rng.integers(0, n, n_edges).astype(np.int64)
    deg = np.bincount(src, minlength=n).astype(np.int64)
    p = program(n, n_edges, iters, thresh)

    # active_rate seeds the gate: inactive ranks start below THRESH
    R0 = rng.integers(thresh + 1, SC // 2, n).astype(np.int64)
    R0[rng.random(n) >= active_rate] = rng.integers(0, thresh, 1)[0]
    mem = {"R": R0, "C": np.zeros(n, dtype=np.int64), "src": src,
           "dst": dst, "deg": deg}
    return BenchCase("pagerank", p.build(), mem, {"R", "C"},
                     note=f"n={n} edges={n_edges} iters={iters} "
                          f"active_rate={active_rate}")
