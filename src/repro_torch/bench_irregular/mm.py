"""mm — maximal matching in a bipartite graph (§8.1.2).

One flat ``match`` array holds both sides (u side at [0,N), v side at
[N,2N)) so a single LSQ serves the kernel, as in the paper.  Nested control
LoD: the inner branch is itself guarded by an LoD branch (a 2-deep chain).

    for e in range(E):
        u = eu[e]; v = ev[e]
        mu = match[u]
        if mu < 0:
            mv = match[N + v]
            if mv < 0:
                match[u] = v; match[N + v] = u
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function


def build(n_nodes: int = 48, n_edges: int = 160, true_rate: float = None,
          seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    f = Function("mm")
    f.array("match", 2 * n_nodes)
    f.array("eu", n_edges)
    f.array("ev", n_edges)

    e = f.block("entry")
    e.const("zero", 0)
    e.const("one", 1)
    e.const("N", n_nodes)
    e.const("E", n_edges)
    e.br("header")
    h = f.block("header")
    h.phi("i", [("entry", "zero"), ("latch", "i_next")])
    h.bin("c", "<", "i", "E")
    h.cbr("c", "body", "exit")
    b = f.block("body")
    b.load("u", "eu", "i")
    b.load("v", "ev", "i")
    b.load("mu", "match", "u")
    b.bin("p0", "<", "mu", "zero")
    b.cbr("p0", "t1", "latch")
    t1 = f.block("t1")
    t1.bin("vN", "+", "v", "N")
    t1.load("mv", "match", "vN")
    t1.bin("p1", "<", "mv", "zero")
    t1.cbr("p1", "t2", "latch")
    t2 = f.block("t2")
    t2.store("match", "u", "v")
    t2.bin("vN2", "+", "v", "N")
    t2.store("match", "vN2", "u")
    t2.br("latch")
    l = f.block("latch")
    l.bin("i_next", "+", "i", "one")
    l.br("header")
    f.block("exit").ret()
    f.verify()

    match0 = np.full(2 * n_nodes, -1, dtype=np.int64)
    if true_rate is None:
        eu = rng.integers(0, n_nodes, n_edges).astype(np.int64)
        ev = rng.integers(0, n_nodes, n_edges).astype(np.int64)
    else:
        # Table-2 instrumentation: mis-speculating edges touch *distinct*
        # pre-matched nodes (no address collisions — we vary only the
        # mis-speculation rate, not the true-RAW serialization).
        half = n_nodes // 2
        match0[:half] = np.arange(half)          # u side pre-matched
        match0[n_nodes:n_nodes + half] = np.arange(half)
        eu = rng.integers(half, n_nodes, n_edges).astype(np.int64)
        ev = rng.integers(half, n_nodes, n_edges).astype(np.int64)
        clash = rng.random(n_edges) >= true_rate
        idx = np.nonzero(clash)[0]
        eu[idx] = idx % half
        ev[idx] = idx % half
    mem = {
        "match": match0,
        "eu": eu,
        "ev": ev,
    }
    return BenchCase("mm", f, mem, {"match"},
                     note=f"nodes={n_nodes} edges={n_edges}")
