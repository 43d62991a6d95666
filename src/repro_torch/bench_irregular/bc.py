"""bc — betweenness-centrality forward phase (§8.1.2): BFS levels plus
shortest-path counts (sigma).  Two decoupled arrays (D and S) — two LSQs,
matching the paper's two-LSQ bc configuration.

    for lvl in range(L):
        for e in range(E):
            du = D[src[e]]
            if du == lvl:
                dv = D[dst[e]]
                if dv < 0:
                    D[dst[e]] = lvl + 1
                    S[dst[e]] += S[src[e]]
                elif dv == lvl + 1:
                    S[dst[e]] += S[src[e]]
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function

from .bfs import bfs_levels, random_graph


def build(n_nodes: int = 40, n_edges: int = 160, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    src, dst = random_graph(n_nodes, n_edges, rng)
    _, levels = bfs_levels(n_nodes, src, dst)

    f = Function("bc")
    f.array("D", n_nodes)
    f.array("S", n_nodes)
    f.array("src", n_edges)
    f.array("dst", n_edges)

    e = f.block("entry")
    e.const("zero", 0)
    e.const("one", 1)
    e.const("E", n_edges)
    e.const("L", levels)
    e.br("lh")
    lh = f.block("lh")
    lh.phi("lvl", [("entry", "zero"), ("ll", "lvl_next")])
    lh.bin("cl", "<", "lvl", "L")
    lh.cbr("cl", "eh", "exit")
    eh = f.block("eh")
    eh.phi("i", [("lh", "zero"), ("el", "i_next")])
    eh.bin("ce", "<", "i", "E")
    eh.cbr("ce", "body", "ll")
    b = f.block("body")
    b.load("u", "src", "i")
    b.load("du", "D", "u")
    b.bin("p0", "==", "du", "lvl")
    b.cbr("p0", "t1", "el")
    t1 = f.block("t1")
    t1.load("v", "dst", "i")
    t1.load("dv", "D", "v")
    t1.bin("nl", "+", "lvl", "one")
    t1.bin("p1", "<", "dv", "zero")
    t1.cbr("p1", "t2", "t3")
    t2 = f.block("t2")  # newly discovered: set level, seed sigma
    t2.store("D", "v", "nl")
    t2.load("su", "S", "u")
    t2.load("sv", "S", "v")
    t2.bin("ns", "+", "sv", "su")
    t2.store("S", "v", "ns")
    t2.br("el")
    t3 = f.block("t3")  # already on next level: accumulate sigma
    t3.bin("p2", "==", "dv", "nl")
    t3.cbr("p2", "t4", "el")
    t4 = f.block("t4")
    t4.load("su2", "S", "u")
    t4.load("sv2", "S", "v")
    t4.bin("ns2", "+", "sv2", "su2")
    t4.store("S", "v", "ns2")
    t4.br("el")
    el = f.block("el")
    el.bin("i_next", "+", "i", "one")
    el.br("eh")
    ll = f.block("ll")
    ll.bin("lvl_next", "+", "lvl", "one")
    ll.br("lh")
    f.block("exit").ret()
    f.verify()

    D = np.full(n_nodes, -1, dtype=np.int64)
    D[0] = 0
    S = np.zeros(n_nodes, dtype=np.int64)
    S[0] = 1
    mem = {"D": D, "S": S, "src": src, "dst": dst}
    return BenchCase("bc", f, mem, {"D", "S"},
                     note=f"n={n_nodes} e={n_edges} levels={levels} (2 LSQs)")
