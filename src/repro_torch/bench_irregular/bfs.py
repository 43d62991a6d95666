"""bfs — breadth-first traversal (§8.1.2), edge-centric level-synchronous
form (the bounded-memory restructuring of the queue version; §4's φ-carried
data LoD rules out dynamic queues in both the paper's system and ours).

    for lvl in range(L):
        for e in range(E):
            du = D[src[e]]
            if du == lvl:
                dv = D[dst[e]]
                if dv < 0:
                    D[dst[e]] = lvl + 1
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function


def random_graph(n: int, e: int, rng) -> tuple:
    src = rng.integers(0, n, e).astype(np.int64)
    dst = rng.integers(0, n, e).astype(np.int64)
    return src, dst


def bfs_levels(n: int, src_arr, dst_arr, root: int = 0):
    d = np.full(n, -1, dtype=np.int64)
    d[root] = 0
    lvl = 0
    while True:
        frontier = np.nonzero(d == lvl)[0]
        if len(frontier) == 0:
            break
        mask = np.isin(src_arr, frontier)
        new = dst_arr[mask]
        new = new[d[new] < 0]
        if len(new) == 0:
            break
        d[new] = lvl + 1
        lvl += 1
    return d, lvl + 1


def build(n_nodes: int = 48, n_edges: int = 192, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    src, dst = random_graph(n_nodes, n_edges, rng)
    _, levels = bfs_levels(n_nodes, src, dst)

    f = Function("bfs")
    f.array("D", n_nodes)
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
    t1.bin("p1", "<", "dv", "zero")
    t1.cbr("p1", "t2", "el")
    t2 = f.block("t2")
    t2.bin("nl", "+", "lvl", "one")
    t2.store("D", "v", "nl")
    t2.br("el")
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
    mem = {"D": D, "src": src, "dst": dst}
    return BenchCase("bfs", f, mem, {"D"},
                     note=f"n={n_nodes} e={n_edges} levels={levels}")
