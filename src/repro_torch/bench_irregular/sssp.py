"""sssp — single-source shortest paths (§8.1.2), edge-centric Bellman–Ford
rounds (the bounded restructuring of the paper's Dijkstra; the priority
queue is a φ-carried data LoD, §4).

    for r in range(R):
        for e in range(E):
            t = D[src[e]] + w[e]
            if t < D[dst[e]]:
                D[dst[e]] = t
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function

INF = 1 << 20


def build(n_nodes: int = 40, n_edges: int = 160, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    w = rng.integers(1, 16, n_edges).astype(np.int64)

    # rounds to convergence (numpy Bellman-Ford)
    d = np.full(n_nodes, INF, dtype=np.int64)
    d[0] = 0
    rounds = 0
    while True:
        nd = d.copy()
        np.minimum.at(nd, dst, d[src] + w)
        rounds += 1
        if np.array_equal(nd, d):
            break
        d = nd

    f = Function("sssp")
    f.array("D", n_nodes)
    f.array("src", n_edges)
    f.array("dst", n_edges)
    f.array("w", n_edges)

    e = f.block("entry")
    e.const("zero", 0)
    e.const("one", 1)
    e.const("E", n_edges)
    e.const("R", rounds)
    e.br("rh")
    rh = f.block("rh")
    rh.phi("r", [("entry", "zero"), ("rl", "r_next")])
    rh.bin("cr", "<", "r", "R")
    rh.cbr("cr", "eh", "exit")
    eh = f.block("eh")
    eh.phi("i", [("rh", "zero"), ("el", "i_next")])
    eh.bin("ce", "<", "i", "E")
    eh.cbr("ce", "body", "rl")
    b = f.block("body")
    b.load("u", "src", "i")
    b.load("du", "D", "u")
    b.load("wv", "w", "i")
    b.bin("t", "+", "du", "wv")
    b.load("v", "dst", "i")
    b.load("dv", "D", "v")
    b.bin("p", "<", "t", "dv")
    b.cbr("p", "then", "el")
    t = f.block("then")
    t.store("D", "v", "t")
    t.br("el")
    el = f.block("el")
    el.bin("i_next", "+", "i", "one")
    el.br("eh")
    rl = f.block("rl")
    rl.bin("r_next", "+", "r", "one")
    rl.br("rh")
    f.block("exit").ret()
    f.verify()

    D = np.full(n_nodes, INF, dtype=np.int64)
    D[0] = 0
    mem = {"D": D, "src": src, "dst": dst, "w": w}
    return BenchCase("sssp", f, mem, {"D"},
                     note=f"n={n_nodes} e={n_edges} rounds={rounds}")
