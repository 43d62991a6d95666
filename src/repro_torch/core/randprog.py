"""Random reducible loop programs for property-testing the §5/§6 transforms.

Generates single-loop functions with nested conditional trees (depth ≤ 3) in
the paper's benchmark family: decoupled-array loads feeding branch conditions
(control LoD), stores under those branches, read-only index arrays, mixed
tainted/untainted predicates.  Every program is valid input for the full
STA/DAE/SPEC/ORACLE pipeline; the executable Lemma 6.1 property is that
SPEC's committed store sequence and final memory equal the sequential
interpreter's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set

import numpy as np

from .ir import Block, Function


@dataclass
class GenProgram:
    fn: Function
    memory: Dict[str, np.ndarray]
    decoupled: Set[str]
    n_requests: int = 0
    #: negative programs only: the ``repro.verify`` rule that must fire
    expect_rule: str = ""
    #: negative programs only: ``repro.verify.mutate`` kind to apply to
    #: the *compiled* pair before verifying (named by string so this
    #: module never imports ``repro.verify`` — core stays verify-free)
    mutate: str = ""


def generate(seed: int, n_iter: int = 48, max_depth: int = 3,
             max_items: int = 3, assoc_chains: bool = False,
             negative: bool = False) -> GenProgram:
    """One random single-loop program (seeded, deterministic).

    ``assoc_chains=True`` biases generation toward the reduction shape
    the vector backend's segmented-scan forwarding targets: every
    decoupled store becomes a load/add/store chain on the same index
    (``x = A[ix]; A[ix] = x + c``) and index arrays are drawn from a
    small range so same-address runs are long — heavy committed-RAW
    pressure with an associative escape hatch.

    ``negative=True`` instead emits a *known-unsound* program for the
    verifier's negative corpus: even seeds build an irreducible CFG
    (a retreating edge into a two-entry loop — ``expect_rule`` C02, and
    :class:`repro.core.cfg.CFGInfo` must refuse it too); odd seeds build
    a speculation-guaranteed loop whose compiled pair is to be broken by
    the named ``mutate`` kind (``drop-poison`` — ``expect_rule`` P02).
    """
    if negative:
        return _negative(seed, n_iter)
    rng = np.random.RandomState(seed)
    N = int(n_iter)

    f = Function(f"rand{seed}")
    f.array("A", N)
    two_arrays = bool(rng.randint(0, 2))
    if two_arrays:
        f.array("B", N)
    n_idx = rng.randint(1, 4)
    for k in range(n_idx):
        f.array(f"idx{k}", N)

    mem: Dict[str, np.ndarray] = {
        "A": rng.randint(-5, 12, N).astype(np.int64)}
    if two_arrays:
        mem["B"] = rng.randint(-5, 12, N).astype(np.int64)
    hi_idx = max(2, N // 6) if assoc_chains else N
    for k in range(n_idx):
        mem[f"idx{k}"] = rng.randint(0, hi_idx, N).astype(np.int64)

    decoupled = {"A"} | ({"B"} if two_arrays and rng.randint(0, 2) else set())

    e = f.block("entry")
    e.const("zero", 0)
    e.const("one", 1)
    e.const("N", N)
    for c in range(2, 8):
        e.const(f"c{c}", c)
    e.br("header")
    h = f.block("header")
    h.phi("i", [("entry", "zero"), ("latch", "i_next")])
    h.bin("cond", "<", "i", "N")
    h.cbr("cond", "b0", "exit")

    uid = [0]
    n_req = [0]

    def fresh(stem: str) -> str:
        uid[0] += 1
        return f"{stem}{uid[0]}"

    def rand_index(blk: Block, avail: List[str]) -> str:
        """An always-in-bounds index expression."""
        r = rng.randint(0, 3)
        if r == 0:
            return "i"
        if r == 1:
            k = rng.randint(0, n_idx)
            d = fresh("j")
            blk.load(d, f"idx{k}", "i")
            return d
        # (i * a + b) % N
        a = fresh("t")
        blk.bin(a, "*", "i", f"c{rng.randint(2, 8)}")
        b = fresh("t")
        blk.bin(b, "+", a, f"c{rng.randint(2, 8)}")
        m = fresh("t")
        blk.bin(m, "%", b, "N")
        return m

    def rand_value(blk: Block, avail: List[str]) -> str:
        if avail and rng.randint(0, 2):
            v = avail[rng.randint(0, len(avail))]
            d = fresh("v")
            blk.bin(d, "+", v, f"c{rng.randint(2, 8)}")
            return d
        return "i" if rng.randint(0, 2) else f"c{rng.randint(2, 8)}"

    def emit_items(blk: Block, avail: List[str], depth: int) -> Block:
        """Emit a straight-line run of items + optional nested ifs; returns
        the block where emission continues."""
        for _ in range(rng.randint(1, max_items + 1)):
            choice = rng.randint(0, 4)
            if choice == 0:  # decoupled load
                arr = _pick_dec(rng, decoupled)
                d = fresh("a")
                blk.load(d, arr, rand_index(blk, avail))
                avail.append(d)
                n_req[0] += 1
            elif choice == 1:  # decoupled store
                arr = _pick_dec(rng, decoupled)
                if assoc_chains:
                    # associative read-modify-write on one address:
                    # x = arr[ix]; arr[ix] = x + c
                    ix = rand_index(blk, avail)
                    x = fresh("a")
                    blk.load(x, arr, ix)
                    v = fresh("v")
                    blk.bin(v, "+", x, f"c{rng.randint(2, 8)}")
                    blk.store(arr, ix, v)
                    avail.append(x)
                    n_req[0] += 2
                else:
                    blk.store(arr, rand_index(blk, avail),
                              rand_value(blk, avail))
                    n_req[0] += 1
            elif choice == 2 and depth < max_depth:  # nested if
                cond = _rand_cond(rng, blk, avail, fresh)
                tname, jname = fresh("t."), fresh("j.")
                tblk = f.block(tname)
                join = f.block(jname)
                has_else = bool(rng.randint(0, 2))
                if has_else:
                    ename = fresh("e.")
                    eblk = f.block(ename)
                    blk.cbr(cond, tname, ename)
                    out_e = emit_items(eblk, list(avail), depth + 1)
                    out_e.br(jname)
                else:
                    blk.cbr(cond, tname, jname)
                out_t = emit_items(tblk, list(avail), depth + 1)
                out_t.br(jname)
                blk = join
            else:  # plain arithmetic noise
                d = fresh("n")
                blk.bin(d, "+", "i", f"c{rng.randint(2, 8)}")
        return blk

    body = f.block("b0")
    last = emit_items(body, [], 0)
    last.br("latch")
    l = f.block("latch")
    l.bin("i_next", "+", "i", "one")
    l.br("header")
    f.block("exit").ret()
    f.verify()

    return GenProgram(f, mem, decoupled, n_req[0])


def _negative(seed: int, n_iter: int) -> GenProgram:
    """One known-unsound program (see ``generate(negative=True)``)."""
    rng = np.random.RandomState(seed)
    N = int(n_iter)
    mem = {"A": rng.randint(-5, 12, N).astype(np.int64)}
    c = int(rng.randint(2, 8))

    if seed % 2 == 0:
        # irreducible: entry branches into the middle of the b1<->b2
        # cycle, so b2->b1 is a retreating edge that is not a back edge
        f = Function(f"neg{seed}.irreducible")
        f.array("A", N)
        e = f.block("entry")
        e.const("zero", 0)
        e.const("one", 1)
        e.const("N", N)
        e.bin("c", "<", "zero", "N")
        e.cbr("c", "b1", "b2")
        b1 = f.block("b1")
        b1.load("a", "A", "zero")
        b1.br("b2")
        b2 = f.block("b2")
        b2.bin("t", "+", "zero", "one")
        b2.cbr("c", "b1", "exit")
        f.block("exit").ret()
        f.verify()
        return GenProgram(f, mem, {"A"},
                          expect_rule="C02-irreducible-cfg")

    # speculation-guaranteed loop: a decoupled load feeds the branch
    # guarding a store, so the compiled CU must carry poison_st sites —
    # dropping one leaves a store request no token ever resolves
    f = Function(f"neg{seed}.dropguard")
    f.array("A", N)
    e = f.block("entry")
    e.const("zero", 0)
    e.const("one", 1)
    e.const("N", N)
    e.const("c", c)
    e.br("header")
    h = f.block("header")
    h.phi("i", [("entry", "zero"), ("latch", "i_next")])
    h.bin("cond", "<", "i", "N")
    h.cbr("cond", "b0", "exit")
    b0 = f.block("b0")
    b0.load("a", "A", "i")
    b0.bin("p", ">", "a", "c")
    b0.cbr("p", "taken", "latch")
    t = f.block("taken")
    t.bin("v", "+", "a", "c")
    t.store("A", "i", "v")
    t.br("latch")
    l = f.block("latch")
    l.bin("i_next", "+", "i", "one")
    l.br("header")
    f.block("exit").ret()
    f.verify()
    return GenProgram(f, mem, {"A"}, n_requests=2 * N,
                      expect_rule="P02-request-unresolved",
                      mutate="drop-poison")


def _pick_dec(rng, decoupled: Set[str]) -> str:
    ds = sorted(decoupled)
    return ds[rng.randint(0, len(ds))]


def _rand_cond(rng, blk: Block, avail: List[str], fresh) -> str:
    ops = ["<", ">", "<=", ">=", "==", "!="]
    op = ops[rng.randint(0, len(ops))]
    d = fresh("p")
    if avail and rng.randint(0, 3) < 2:  # tainted branch (control LoD)
        v = avail[rng.randint(0, len(avail))]
        blk.bin(d, op, v, f"c{rng.randint(2, 8)}")
    else:  # untainted
        t = fresh("t")
        blk.bin(t, "%", "i", f"c{rng.randint(2, 8)}")
        blk.bin(d, op, t, f"c{rng.randint(2, 8)}")
    return d
