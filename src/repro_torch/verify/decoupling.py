"""Decoupling translation validation (rules D01/D02/D04/D05).

Independently re-derives, from the final slices alone, what the
transform pipeline *claimed* when it built a
:class:`repro_torch.core.pipeline.CompiledDAE` — without importing anything
from ``repro_torch.codegen`` (the classifier under audit; see
``docs/verify.md``).

**D02 — sync flags.**  ``finalize_agu`` marks each ``send_ld`` as sync
(its value feeds later AGU code) or fire-and-forget.  The flag drives
whether the ahead-of-time AGU run may treat the load as served from
initial memory, so a wrong flag is a soundness bug, not a perf bug: the
use-set is recomputed here from scratch and compared against the
recorded ``meta['sync']``.

**D01 — AGU purity.**  The stream schedule (AGU runs to completion
before the CU starts) is only legal when no *sync* load targets an array
that also receives store requests (AGU ``send_st`` or CU
``produce_st``/``poison_st``): such a load may observe a value only the
CU computes — the paper's loss-of-decoupling round trip.  Re-derived
with the recomputed (not recorded) sync set.

**D04/D05 — forwarding-chain legality.**  Segmented-scan RAW forwarding
(``repro_torch.codegen.epochs``) re-associates per-address ``+`` chains, which
is only sound when each forwarded array has exactly one store slot per
iteration whose committed value is an additive update of exactly one
load slot, on an integral dtype.  :func:`chain_map` re-derives the
chain set per loop by *path enumeration* (each feasible iteration path
must agree on the slot index) rather than the classifier's offset DP —
same verdict, different algorithm, which is what makes the differential
cross-check in ``repro_torch.verify.__main__`` meaningful.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..core.cfg import CFGInfo
from ..core.ir import Function, Instr
from . import poisonflow
from .rules import Diag


# ---------------------------------------------------------------------------
# D01 / D02 — AGU purity and sync-flag translation validation
# ---------------------------------------------------------------------------


def agu_checks(agu: Function, cu: Function) -> List[Diag]:
    """Recompute the AGU use-set and purity class; diff against claims."""
    used: Set[str] = set()
    for blk in agu.blocks.values():
        for i in (*blk.phis, *blk.body):
            used.update(i.uses())
        if blk.term is not None and blk.term.cond is not None:
            used.add(blk.term.cond)

    stored: Set[str] = set()
    for blk in agu.blocks.values():
        for i in blk.body:
            if i.op == "send_st":
                stored.add(i.array)
    for blk in cu.blocks.values():
        for i in blk.body:
            if i.op in ("produce_st", "poison_st"):
                stored.add(i.array)

    diags: List[Diag] = []
    sync_arrays: Set[str] = set()
    for bname, blk in agu.blocks.items():
        for i in blk.body:
            if i.op != "send_ld":
                continue
            is_sync = i.dest is not None and i.dest in used
            if is_sync:
                sync_arrays.add(i.array)
            if bool(i.meta.get("sync")) != is_sync:
                claim = "sync" if i.meta.get("sync") else "fire-and-forget"
                truth = "feeds later AGU code" if is_sync else "is dead"
                diags.append(Diag(
                    "D02-sync-flag-mismatch", f"agu:{bname}",
                    f"send_ld @{i.array} (dest {i.dest!r}) is marked "
                    f"{claim} but its value {truth} — the recorded flag "
                    f"contradicts the recomputed use-set"))

    # D01 is a *stream-schedule* precondition, not an always-on invariant:
    # a value-dependent AGU is legal IR that codegen must refuse to run
    # ahead of time.  We report it so the differential check can demand
    # that codegen's classifier refuses too (and vice versa).
    for a in sorted(sync_arrays & stored):
        diags.append(Diag(
            "D01-agu-value-dependent", "agu",
            f"sync send_ld @{a} targets an array that also receives "
            f"store requests — the AGU may need a value only the CU "
            f"produces (loss of decoupling), so no ahead-of-time "
            f"stream schedule exists"))
    return diags


# ---------------------------------------------------------------------------
# D04 / D05 — forwarding-chain re-derivation by path enumeration
# ---------------------------------------------------------------------------


def chain_map(cu: Function, cfg: CFGInfo
              ) -> Dict[str, Dict[str, Tuple[Optional[int], str]]]:
    """Per innermost loop: ``{array: (slot | None, reason)}``.

    ``slot`` is the chain-load slot index when the array is a legal
    forwarding chain on *every* feasible iteration path, else ``None``
    with the refusal reason.  Arrays with no in-loop load/store pairing
    are omitted (no in-epoch RAW is possible, nothing to forward).
    """
    out: Dict[str, Dict[str, Tuple[Optional[int], str]]] = {}
    inner = [h for h in cfg.loops
             if not any(h2 != h and h2 in cfg.loops[h] for h2 in cfg.loops)]
    defs: Dict[str, Instr] = {}
    for blk in cu.blocks.values():
        for i in (*blk.phis, *blk.body):
            if i.dest is not None:
                defs[i.dest] = i

    for h in inner:
        per_path: List[List[Tuple[str, Instr]]] = []
        try:
            per_path = [fired for _, fired
                        in poisonflow.iter_fired(cu, cfg, h)]
        except poisonflow.Coverage:
            continue  # match_tokens already reports C03 for this loop
        arrays = {i.array for fired in per_path for _, i in fired}
        verdicts: Dict[str, Tuple[Optional[int], str]] = {}
        for a in sorted(arrays):
            verdict = _classify_array(a, per_path, defs)
            if verdict is not None:
                verdicts[a] = verdict
        if verdicts:
            out[h] = verdicts
    return out


def _classify_array(a: str, per_path: List[List[Tuple[str, Instr]]],
                    defs: Dict[str, Instr]
                    ) -> Optional[Tuple[Optional[int], str]]:
    """One array in one loop -> (slot, 'chain') | (None, reason) | None."""
    any_load = any_store = False
    store_counts: Set[int] = set()
    # (site instr, its path's ordered consume list) for committing sites
    commits: List[Tuple[Instr, List[Instr]]] = []
    for fired in per_path:
        loads = [i for _, i in fired
                 if i.op == "consume_ld" and i.array == a]
        stores = [i for _, i in fired
                  if i.op in ("produce_st", "poison_st") and i.array == a]
        any_load |= bool(loads)
        any_store |= bool(stores)
        store_counts.add(len(stores))
        for i in stores:
            if i.op == "produce_st":
                commits.append((i, loads))
    if not (any_load and any_store):
        return None  # no in-epoch RAW possible
    if store_counts != {1}:
        return None, (f"store slot count varies or exceeds one per "
                      f"iteration ({sorted(store_counts)})")
    if not commits:
        return None, "store slot never commits (all sites poison)"

    slots: Set[int] = set()
    for site, loads in commits:
        spine = _spine(site.args[0], a, defs)
        if len(spine) != 1:
            return None, ("store value is not a pure '+' update of "
                          "exactly one load slot")
        root = next(iter(spine))  # instr identity (id), not value equality
        load_ids = [id(x) for x in loads]
        if root not in load_ids:
            return None, ("chain load is not consumed on the committing "
                          "path")
        slots.add(load_ids.index(root))
    if len(slots) != 1:
        return None, (f"chain slot index disagrees across paths "
                      f"({sorted(slots)})")
    return next(iter(slots)), "chain"


def _spine(v, a: str, defs: Dict[str, Instr]) -> Set[int]:
    """Ids of ``a``-consumes reachable from ``v`` through '+' only."""
    if not isinstance(v, str):
        return set()
    i = defs.get(v)
    if i is None:
        return set()
    if i.op == "consume_ld" and i.array == a:
        return {id(i)}
    if i.op == "bin" and i.args[0] == "+":
        return _spine(i.args[1], a, defs) | _spine(i.args[2], a, defs)
    return set()


def chain_dtype_check(cu: Function, cfg: CFGInfo,
                      memory: Optional[dict]) -> List[Diag]:
    """D05: forwarding chains must ride integral arrays (needs memory)."""
    if not memory:
        return []
    diags: List[Diag] = []
    for h, verdicts in chain_map(cu, cfg).items():
        for a, (slot, _why) in verdicts.items():
            if slot is None or a not in memory:
                continue
            kind = getattr(getattr(memory[a], "dtype", None), "kind", "i")
            if kind not in ("i", "u", "b"):
                diags.append(Diag(
                    "D05-chain-dtype", f"cu:{h}",
                    f"forwarding chain on array {a!r} with "
                    f"non-integral dtype {memory[a].dtype} — float '+' "
                    f"re-association is not bit-stable under "
                    f"segmented-scan forwarding"))
    return diags
