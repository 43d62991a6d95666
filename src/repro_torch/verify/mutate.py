"""Seeded soundness mutator — proves the verifier has teeth.

Each mutation takes a *clone* of a compiled AGU/CU pair and breaks one
specific soundness invariant in the IR (drop a poison, widen an epoch
past its fence by reordering, unguard a speculative commit, ...),
returning the rule ID that must catch it.  ``tests/test_torch_verify.py``
asserts every applicable mutant is caught by exactly its expected rule —
a surviving mutant is a verifier hole, a mutant caught by the *wrong*
rule is a mislabelled diagnostic.

Mutations are applicability-gated: ``mutants`` silently skips kinds the
given program has no material for (e.g. ``drop-steer-reset`` on a
program with no steered poisons).  The seed picks *which* instance is
mutated when several qualify, so sweeps explore different sites.
"""
from __future__ import annotations

import random
from types import SimpleNamespace
from typing import Iterator, List, Optional, Tuple

from ..core.ir import Function, Instr

#: mutation kind -> rule expected to catch it (the registry's contract)
EXPECTED = {
    "drop-poison": "P02-request-unresolved",
    "drop-produce": "P02-request-unresolved",
    "retarget-poison": "P02-request-unresolved",
    "dup-request": "P02-request-unresolved",
    "swap-agu-requests": "D03-epoch-fence-violated",
    "reorder-chain-store": "D03-epoch-fence-violated",
    "flip-sync-flag": "D02-sync-flag-mismatch",
    "unguard-commit": "P01-poison-escapes-commit",
    "escape-store": "P01-poison-escapes-commit",
    "drop-steer-reset": "P03-steer-discipline",
    "drop-steer-set": "P03-steer-discipline",
}


def _clone(compiled) -> SimpleNamespace:
    """Fresh AGU/CU copies; the original pair is never touched."""
    return SimpleNamespace(agu=compiled.agu.clone(),
                           cu=compiled.cu.clone())


def _cu_sites(cu: Function, op: str) -> List[Tuple[str, int]]:
    return [(b, k) for b, blk in cu.blocks.items()
            for k, i in enumerate(blk.body) if i.op == op]


def mutants(compiled, seed: int = 0
            ) -> Iterator[Tuple[str, SimpleNamespace, str]]:
    """Yield ``(kind, mutated_pair, expected_rule)`` for applicable kinds."""
    rng = random.Random(seed)
    for kind in EXPECTED:
        m = _clone(compiled)
        if _APPLY[kind](m, rng):
            yield kind, m, EXPECTED[kind]


# ---------------------------------------------------------------------------
# the mutations (each returns True when it found material and applied)
# ---------------------------------------------------------------------------


def _drop_poison(m, rng) -> bool:
    """Delete one poison token: its store request is never resolved."""
    sites = _cu_sites(m.cu, "poison_st")
    if not sites:
        return False
    b, k = rng.choice(sites)
    del m.cu.blocks[b].body[k]
    return True


def _drop_produce(m, rng) -> bool:
    """Delete one committing store token (same FIFO wedge, other op)."""
    sites = _cu_sites(m.cu, "produce_st")
    if not sites:
        return False
    b, k = rng.choice(sites)
    del m.cu.blocks[b].body[k]
    return True


def _retarget_poison(m, rng) -> bool:
    """Point a poison at the wrong array's FIFO."""
    sites = _cu_sites(m.cu, "poison_st")
    arrays = {i.array for blk in m.cu.blocks.values() for i in blk.body
              if i.op in ("consume_ld", "produce_st", "poison_st")}
    if not sites or len(arrays) < 2:
        return False
    b, k = rng.choice(sites)
    i = m.cu.blocks[b].body[k]
    i.array = rng.choice(sorted(arrays - {i.array}))
    return True


def _dup_request(m, rng) -> bool:
    """Fire a store request twice: one token can never answer both."""
    sites = [(b, k) for b, blk in m.agu.blocks.items()
             for k, i in enumerate(blk.body) if i.op == "send_st"]
    if not sites:
        return False
    b, k = rng.choice(sites)
    m.agu.blocks[b].body.insert(k + 1, m.agu.blocks[b].body[k].clone())
    return True


def _swap_agu_requests(m, rng) -> bool:
    """Reorder two same-array AGU requests: epoch widens past the fence.

    The CU still resolves tokens in program order, so the per-array FIFO
    the ``gather_limit`` fence assumes no longer matches the request
    stream — a load gathers past an unflushed aliasing store.
    """
    sites = []
    for b, blk in m.agu.blocks.items():
        per: dict = {}
        for k, i in enumerate(blk.body):
            if i.op in ("send_ld", "send_st"):
                per.setdefault(i.array, []).append(k)
        for a, ks in per.items():
            if len(ks) >= 2:
                sites.append((b, ks[0], ks[1]))
    if not sites:
        return False
    b, k0, k1 = rng.choice(sites)
    body = m.agu.blocks[b].body
    body[k0], body[k1] = body[k1], body[k0]
    return True


def _reorder_chain_store(m, rng) -> bool:
    """Move a chain's produce above its consume (store before load)."""
    sites = []
    for b, blk in m.cu.blocks.items():
        for k, i in enumerate(blk.body):
            if i.op != "produce_st":
                continue
            for j in range(k):
                ij = blk.body[j]
                if ij.op == "consume_ld" and ij.array == i.array:
                    sites.append((b, j, k))
                    break
    if not sites:
        return False
    b, j, k = rng.choice(sites)
    body = m.cu.blocks[b].body
    body.insert(j, body.pop(k))
    return True


def _flip_sync_flag(m, rng) -> bool:
    """Lie about a send_ld's sync-ness (breaks the ahead-of-time proof)."""
    sites = [(b, k) for b, blk in m.agu.blocks.items()
             for k, i in enumerate(blk.body) if i.op == "send_ld"]
    if not sites:
        return False
    b, k = rng.choice(sites)
    i = m.agu.blocks[b].body[k]
    i.meta["sync"] = not i.meta.get("sync")
    return True


def _unguard_commit(m, rng) -> bool:
    """Fold a speculation head's branch: the commit retires on all paths.

    Folding toward the wrong arm merely severs the commit (a different
    bug); the mutation only counts when the *taint rule itself* now
    fires, so every yielded mutant is a genuine unguarded-commit break.
    """
    from ..core.cfg import CFGInfo
    from .poisonflow import taint_check
    if not any(i.op == "consume_ld" and i.meta.get("speculative")
               for blk in m.cu.blocks.values() for i in blk.body):
        return False
    cands = [b for b, blk in m.cu.blocks.items()
             if blk.term.kind == "cbr" and not blk.synthetic]
    rng.shuffle(cands)
    for h in cands:
        blk = m.cu.blocks[h]
        saved = blk.term.clone()
        for t in saved.targets:
            blk.term.kind = "br"
            blk.term.targets = (t,)
            blk.term.cond = None
            try:
                if taint_check(m.cu, CFGInfo(m.cu)):
                    return True
            except ValueError:
                pass  # fold broke the CFG shape: not this arm
            blk.term = saved.clone()
    return False


def _escape_store(m, rng) -> bool:
    """Commit a speculative value unconditionally at the loop latch."""
    from ..core.cfg import CFGInfo
    if not m.cu.arrays:
        return False
    try:
        cfg = CFGInfo(m.cu)
    except ValueError:
        return False
    spec = [(b, i) for b, blk in m.cu.blocks.items() for i in blk.body
            if i.op == "consume_ld" and i.meta.get("speculative")
            and i.dest is not None]
    # the def must dominate the latch for the IR to stay well-formed,
    # and the latch post-dominates the head — the P01 shape by design
    cands = []
    for b, i in spec:
        loop = cfg.innermost_loop(b)
        if loop is None:
            continue
        latch = cfg.loop_latch[loop]
        if cfg.dominates(b, latch):
            cands.append((i.dest, latch))
    if not cands:
        return False
    v, latch = rng.choice(cands)
    arr = sorted(m.cu.arrays)[0]
    m.cu.blocks[latch].body.append(Instr("store", None, (v, v), arr))
    return True


def _drop_steer_reset(m, rng) -> bool:
    """Remove a steering flag's loop-header reset (stale-flag leak)."""
    sites = [(b, k) for b, blk in m.cu.blocks.items()
             for k, i in enumerate(blk.body)
             if i.op == "setreg" and i.meta.get("imm") == 0]
    if not sites:
        return False
    b, k = rng.choice(sites)
    del m.cu.blocks[b].body[k]
    return True


def _drop_steer_set(m, rng) -> bool:
    """Remove a steering flag's specBB set (poison never fires)."""
    sites = [(b, k) for b, blk in m.cu.blocks.items()
             for k, i in enumerate(blk.body)
             if i.op == "setreg" and i.meta.get("imm") == 1]
    if not sites:
        return False
    b, k = rng.choice(sites)
    del m.cu.blocks[b].body[k]
    return True


_APPLY = {
    "drop-poison": _drop_poison,
    "drop-produce": _drop_produce,
    "retarget-poison": _retarget_poison,
    "dup-request": _dup_request,
    "swap-agu-requests": _swap_agu_requests,
    "reorder-chain-store": _reorder_chain_store,
    "flip-sync-flag": _flip_sync_flag,
    "unguard-commit": _unguard_commit,
    "escape-store": _escape_store,
    "drop-steer-reset": _drop_steer_reset,
    "drop-steer-set": _drop_steer_set,
}


def check_mutants(compiled, memory: Optional[dict] = None, seed: int = 0
                  ) -> List[Tuple[str, str, bool]]:
    """Run every applicable mutant; return ``(kind, expected, caught)``.

    ``caught`` is True when :func:`repro_torch.verify.verify_compiled` reports
    the expected rule for the mutated pair.  Used by the CLI's
    ``--mutants`` mode and the mutation-testing gate in the test suite.
    """
    from . import verify_compiled
    out = []
    for kind, mut, rule in mutants(compiled, seed):
        diags = verify_compiled(mut, memory)
        out.append((kind, rule, any(d.rule == rule for d in diags)))
    return out
