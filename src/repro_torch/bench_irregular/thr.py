"""thr — RGB threshold (§8.1.2): zero all three channels of pixels whose R
channel exceeds the threshold.  Interleaved RGB in one array (one LSQ, as in
the paper); one poison block with three poison calls.

    for i in range(npix):
        r = img[3i]
        if r > T:
            img[3i] = 0; img[3i+1] = 0; img[3i+2] = 0
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Function


def build(npix: int = 160, threshold: int = 248, true_rate: float = None,
          seed: int = 0):
    from . import BenchCase

    rng = np.random.default_rng(seed)
    f = Function("thr")
    f.array("img", 3 * npix)

    e = f.block("entry")
    e.const("zero", 0)
    e.const("one", 1)
    e.const("two", 2)
    e.const("three", 3)
    e.const("N", npix)
    e.const("T", threshold)
    e.br("header")
    h = f.block("header")
    h.phi("i", [("entry", "zero"), ("latch", "i_next")])
    h.bin("c", "<", "i", "N")
    h.cbr("c", "body", "exit")
    b = f.block("body")
    b.bin("base", "*", "i", "three")
    b.load("r", "img", "base")
    b.bin("p", ">", "r", "T")
    b.cbr("p", "then", "latch")
    t = f.block("then")
    t.store("img", "base", "zero")
    t.bin("g", "+", "base", "one")
    t.store("img", "g", "zero")
    t.bin("bb", "+", "base", "two")
    t.store("img", "bb", "zero")
    t.br("latch")
    l = f.block("latch")
    l.bin("i_next", "+", "i", "one")
    l.br("header")
    f.block("exit").ret()
    f.verify()

    img = rng.integers(0, 256, 3 * npix).astype(np.int64)
    if true_rate is not None:
        # Table-2 instrumentation: pick R channels to sit above/below T
        taken = rng.random(npix) < true_rate
        img[0::3] = np.where(taken, threshold + 1 +
                             rng.integers(0, 100, npix),
                             rng.integers(0, threshold, npix))
    return BenchCase("thr", f, {"img": img}, {"img"},
                     note=f"npix={npix} T={threshold} true_rate={true_rate}")
