"""fw — Floyd–Warshall all-pairs distances on a dense matrix (§8.1.2).

Triple loop nest; the speculated region lives in the innermost (j) loop:

    for k: for i: for j:
        t = d[i*n+k] + d[k*n+j]
        old = d[i*n+j]
        if t < old:
            d[i*n+j] = t
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function


def build(n: int = 10, seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    f = Function("fw")
    f.array("d", n * n)

    e = f.block("entry")
    e.const("zero", 0)
    e.const("one", 1)
    e.const("n", n)
    e.br("kh")

    kh = f.block("kh")
    kh.phi("k", [("entry", "zero"), ("kl", "k_next")])
    kh.bin("ck", "<", "k", "n")
    kh.cbr("ck", "ih", "exit")

    ih = f.block("ih")
    ih.phi("i", [("kh", "zero"), ("il", "i_next")])
    ih.bin("ci", "<", "i", "n")
    ih.cbr("ci", "jh", "kl")

    jh = f.block("jh")
    jh.phi("j", [("ih", "zero"), ("jl", "j_next")])
    jh.bin("cj", "<", "j", "n")
    jh.cbr("cj", "body", "il")

    b = f.block("body")
    b.bin("ik0", "*", "i", "n")
    b.bin("ik", "+", "ik0", "k")
    b.load("dik", "d", "ik")
    b.bin("kj0", "*", "k", "n")
    b.bin("kj", "+", "kj0", "j")
    b.load("dkj", "d", "kj")
    b.bin("t", "+", "dik", "dkj")
    b.bin("ij0", "*", "i", "n")
    b.bin("ij", "+", "ij0", "j")
    b.load("dij", "d", "ij")
    b.bin("p", "<", "t", "dij")
    b.cbr("p", "then", "jl")
    t = f.block("then")
    t.store("d", "ij", "t")
    t.br("jl")

    jl = f.block("jl")
    jl.bin("j_next", "+", "j", "one")
    jl.br("jh")
    il = f.block("il")
    il.bin("i_next", "+", "i", "one")
    il.br("ih")
    kl = f.block("kl")
    kl.bin("k_next", "+", "k", "one")
    kl.br("kh")
    f.block("exit").ret()
    f.verify()

    d = rng.integers(1, 64, (n, n)).astype(np.int64)
    np.fill_diagonal(d, 0)
    return BenchCase("fw", f, {"d": d.reshape(-1)}, {"d"}, note=f"n={n}")
