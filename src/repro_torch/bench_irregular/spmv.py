"""spmv — sparse vector-matrix multiply (§8.1.2, 20×20).

Vector x and output y share one decoupled array ``V`` (x at [0,n), y at
[n,2n)) so one LSQ serves the kernel.  Zero entries of x make the update
branch-dependent on a decoupled load (control LoD):

    for nz in range(NNZ):
        xv = V[col[nz]]
        if xv != 0:
            V[n + row[nz]] += val[nz] * xv
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function, LoopNest


def build(n: int = 20, density: float = 0.4, x_zero_rate: float = 0.32,
          seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    rows, cols = np.nonzero(mask)
    vals = rng.integers(1, 9, len(rows)).astype(np.int64)
    nnz = len(rows)

    f = Function("spmv")
    f.array("V", 2 * n)
    f.array("row", nnz)
    f.array("col", nnz)
    f.array("val", nnz)

    nest = LoopNest(f)
    n_name = nest.const(n, "n")
    b = nest.enter("i", nest.const(nnz, "NNZ"))
    b.load("cl", "col", "i")
    b.load("xv", "V", "cl")
    b.bin("p", "!=", "xv", "zero")
    b.cbr("p", "then", nest.latch)
    t = f.block("then")
    t.load("rw", "row", "i")
    t.bin("yi", "+", "rw", n_name)
    t.load("yv", "V", "yi")
    t.load("vv", "val", "i")
    t.bin("prod", "*", "vv", "xv")
    t.bin("acc", "+", "yv", "prod")
    t.store("V", "yi", "acc")
    t.br(nest.latch)
    nest.finish()

    x = rng.integers(1, 9, n).astype(np.int64)
    x[rng.random(n) < x_zero_rate] = 0
    V = np.concatenate([x, np.zeros(n, dtype=np.int64)])
    mem = {"V": V, "row": rows.astype(np.int64),
           "col": cols.astype(np.int64), "val": vals}
    return BenchCase("spmv", f, mem, {"V"}, note=f"n={n} nnz={nnz}")
