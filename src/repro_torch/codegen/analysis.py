"""Slice-structure analysis: which CompiledDAE pairs can run as streams.

The executable backend (``repro.codegen``) runs the AGU slice *ahead of
time* — the software-prefetcher reading of a decoupled access slice — and
then replays the CU slice against the precomputed per-array address
streams.  That two-phase schedule is only legal when the AGU never needs a
value the CU has yet to produce, so the first thing the backend does is
classify the AGU:

* **pure-address** (``AGU_PURE``) — no ``sync`` ``send_ld`` at all: every
  request is fire-and-forget.  This is the paper's post-hoisting Fig. 1c
  shape (the SPEC pipeline's AGU after ``finalize_agu`` drops the sync
  flags whose guarding branches died).
* **sync-read-only** (``AGU_SYNC_SAFE``) — the AGU still blocks on load
  values (``sync`` sends survive), but only for arrays that receive **no
  store request anywhere in the AGU**.  The DU would serve those loads
  straight from initial memory (nothing older can alias), so the
  ahead-of-time run can too.
* **value-dependent** (``AGU_VALUE_DEP``) — a sync load targets an array
  that is also stored.  The load's value may come from a store whose value
  only the CU knows (the Fig. 1b loss-of-decoupling round trip); the AGU
  cannot be run ahead and the backend falls back to the coupled untimed
  interpreter (:mod:`repro.codegen.fallback`).

The op inventory is checked against what the emitters lower
(:data:`SLICE_OPS`); anything else — including a ``bin`` whose operator the
shared expression table does not know — is an explicit fallback reason,
never a silently wrong kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.ir import Function
from ..core.sim.compile import _BINOP_EXPR
# one-way dependency: the classifier borrows the *rule registry* (stable
# IDs for its reason strings) from the verifier; repro.verify's analysis
# modules never import codegen (see docs/verify.md)
from ..verify.rules import tag

AGU_PURE = "pure-address"
AGU_SYNC_SAFE = "sync-read-only"
AGU_VALUE_DEP = "value-dependent"

#: ops the codegen emitters lower (superset check; per-slice legality —
#: send ops in the AGU, consume/produce/poison in the CU — is implied by
#: how :mod:`repro.core.decouple` builds the slices).
SLICE_OPS = frozenset({
    "const", "bin", "select", "load", "store", "setreg", "getreg", "print",
    "send_ld", "send_st", "consume_ld", "produce_st", "poison_st",
})


class CodegenError(RuntimeError):
    """Raised when a requested lowering cannot be performed (strict mode)
    or when generated code detects a slice-contract violation at run time."""


@dataclass
class UniformLoop:
    """One innermost CU loop proven iteration-uniform (vectorisable).

    After if-conversion the loop body is straight-line: every iteration
    consumes exactly ``k_loads[a]`` load values and exactly ``k_stores[a]``
    store slots per decoupled array ``a``, in the same per-array order, so
    a whole epoch of iterations runs as batched array ops with poison as
    a mask (see ``repro.codegen.emit`` mode ``cu-vector``).
    """

    header: str
    body: str                    # taken target of the header's bound test
    latch: str                   # sole in-loop predecessor of the header
    exit: str                    # fall-through target of the bound test
    iv: str                      # induction phi dest (unit stride)
    bound: Any                   # name or literal of the ``iv < bound`` test
    blocks: List[str]            # region (body..latch) in topological order
    k_loads: Dict[str, int] = field(default_factory=dict)
    k_stores: Dict[str, int] = field(default_factory=dict)
    n_ops: int = 0               # per-iteration op count (step accounting)
    #: arrays whose single store slot is an associative update of exactly
    #: one load slot (``value = consume_ld + delta`` through a pure
    #: ``+``-spine) -> that chain load's slot index.  These are the
    #: candidates for segmented-scan RAW forwarding
    #: (:mod:`repro.codegen.epochs`); the vector driver still applies
    #: its dynamic legality checks per epoch.
    fwd_chains: Dict[str, int] = field(default_factory=dict)
    #: per-array reason an array with both loads and stores is *not* a
    #: forwarding candidate (diagnostics for ``CodegenRun.forward_reason``)
    fwd_reasons: Dict[str, str] = field(default_factory=dict)


@dataclass
class SliceAnalysis:
    """What the backend learned about one compiled AGU/CU pair."""

    agu_class: str
    decoupled: Set[str] = field(default_factory=set)
    #: decoupled arrays with at least one AGU store request
    stored: Set[str] = field(default_factory=set)
    #: arrays targeted by surviving sync ``send_ld``s
    sync_arrays: Set[str] = field(default_factory=set)
    #: why the stream schedule is impossible (None = streams are legal)
    stream_reason: Optional[str] = None
    #: data-LoD mids from the pipeline's LoD analysis, when available —
    #: the *static* explanation for a value-dependent AGU (Def. 4.1)
    data_lod_mids: List[int] = field(default_factory=list)
    #: iteration-uniform innermost CU loops (None when the CU cannot take
    #: the vectorised path; ``uniform_reason`` says why)
    uniform_loops: Optional[List[UniformLoop]] = None
    uniform_reason: Optional[str] = None

    @property
    def streamable(self) -> bool:
        """True when the AGU may legally run ahead as a stream schedule."""
        return self.stream_reason is None

    @property
    def vectorizable(self) -> bool:
        """True when the CU proved iteration-uniform (cu-vector eligible)."""
        return self.uniform_loops is not None


def _op_check(fn: Function, slice_name: str) -> Optional[str]:
    for bname, blk in fn.blocks.items():
        for i in blk.body:
            if i.op not in SLICE_OPS:
                return tag("V05-op-not-lowerable",
                           f"{slice_name} op {i.op!r} in {bname} "
                           f"not lowerable")
            if i.op == "bin" and i.args[0] not in _BINOP_EXPR:
                return tag("V05-op-not-lowerable",
                           f"{slice_name} binop {i.args[0]!r} in {bname} "
                           f"not lowerable")
    return None


def analyze(compiled) -> SliceAnalysis:
    """Classify a :class:`repro.core.pipeline.CompiledDAE` for codegen."""
    agu: Function = compiled.agu
    cu: Function = compiled.cu

    decoupled: Set[str] = set()
    stored: Set[str] = set()
    sync_arrays: Set[str] = set()
    for blk in agu.blocks.values():
        for i in blk.body:
            if i.op == "send_ld":
                decoupled.add(i.array)
                if i.meta.get("sync"):
                    sync_arrays.add(i.array)
            elif i.op == "send_st":
                decoupled.add(i.array)
                stored.add(i.array)
    for blk in cu.blocks.values():
        for i in blk.body:
            if i.op in ("consume_ld", "produce_st", "poison_st"):
                decoupled.add(i.array)
                if i.op in ("produce_st", "poison_st"):
                    stored.add(i.array)

    if not sync_arrays:
        agu_class = AGU_PURE
    elif sync_arrays & stored:
        agu_class = AGU_VALUE_DEP
    else:
        agu_class = AGU_SYNC_SAFE

    info = SliceAnalysis(agu_class, decoupled, stored, sync_arrays)

    lod = getattr(compiled, "lod", None)
    if lod is not None:
        info.data_lod_mids = sorted(lod.data_lod)

    if agu_class == AGU_VALUE_DEP:
        bad = sorted(sync_arrays & stored)
        why = (f"AGU is value-dependent: sync load(s) on stored "
               f"array(s) {', '.join(bad)}")
        if info.data_lod_mids:
            why += f" (data-LoD mids {info.data_lod_mids})"
        info.stream_reason = tag("D01-agu-value-dependent", why)
    else:
        info.stream_reason = _op_check(agu, "AGU") or _op_check(cu, "CU")

    info.uniform_loops, info.uniform_reason = uniform_loops(cu)
    return info


# ---------------------------------------------------------------------------
# Iteration-uniformity: which CU loops can run as vectorised epochs
# ---------------------------------------------------------------------------

_DAE_CU_OPS = ("consume_ld", "produce_st", "poison_st")

#: ops the vector emitter lowers to batched expressions.  ``setreg``/
#: ``getreg`` (the steering-flag web of predicated poison groups) are
#: deliberately absent: a ``pred_reg``-guarded ``poison_st`` consumes its
#: store slot only when the flag is set, so the per-iteration slot count
#: is dynamic — the definition of non-uniform.
_VECTOR_OPS = frozenset({"const", "bin", "select", "load", "store",
                         "consume_ld", "produce_st", "poison_st", "print"})


def uniform_loops(fn: Function
                  ) -> Tuple[Optional[List[UniformLoop]], Optional[str]]:
    """Classify ``fn``'s innermost loops for vectorised epoch execution.

    Returns ``(loops, None)`` when every DAE op of the CU sits inside an
    iteration-uniform innermost loop (``loops`` may be empty for a CU with
    no loops at all — the scalar sections then carry no DAE ops either),
    or ``(None, reason)`` naming the first disqualifier.  Memoised on the
    Function (same no-mutation contract as the emitters).
    """
    try:
        return fn._codegen_uniform  # type: ignore[attr-defined]
    except AttributeError:
        pass
    res = _uniform_loops(fn)
    if res[1] is not None:
        # stable rule-ID prefix (repro.verify registry); the human text
        # stays intact as the detail suffix
        res = (None, tag("V01-cu-not-uniform", res[1]))
    fn._codegen_uniform = res  # type: ignore[attr-defined]
    return res


def _uniform_loops(fn: Function):
    from ..core.cfg import CFGInfo
    try:
        cfg = CFGInfo(fn)
    except ValueError as e:
        return None, f"CFG not analyzable: {e}"

    inner = [h for h in cfg.loops
             if not any(h2 != h and h2 in cfg.loops[h] for h2 in cfg.loops)]
    inner.sort(key=list(fn.blocks).index)

    covered: Set[str] = set()
    loops: List[UniformLoop] = []
    for h in inner:
        ul, why = _classify_loop(fn, cfg, h)
        region_dae = any(i.op in _DAE_CU_OPS
                         for b in cfg.loops[h] if b != h
                         for i in fn.blocks[b].body)
        if ul is None:
            if region_dae:
                return None, f"loop {h}: {why}"
            continue  # DAE-free loop that fails the shape checks: scalar
        loops.append(ul)
        covered.update(ul.blocks)
        covered.add(h)

    for bname, blk in fn.blocks.items():
        if bname in covered:
            continue
        for i in blk.body:
            if i.op in _DAE_CU_OPS:
                return None, (f"DAE op {i.op!r} in {bname} outside any "
                              f"iteration-uniform innermost loop")
    return loops, None


def _classify_loop(fn: Function, cfg, h: str):
    """One innermost loop -> (UniformLoop, None) or (None, reason)."""
    body_set = cfg.loops[h]
    hb = fn.blocks[h]

    # -- canonical counted-loop shape (the LoopNest contract) ---------------
    latches = [p for p, blk in fn.blocks.items()
               if p in body_set and h in blk.term.succs() and p != h]
    if len(latches) != 1:
        return None, "multiple latches"
    latch = latches[0]
    if len(hb.phis) != 1:
        return None, "header carries a non-induction loop phi"
    phi = hb.phis[0]
    iv = phi.dest
    nxt = None
    for (pb, v) in phi.args:
        if pb == latch:
            nxt = v
    if nxt is None:
        return None, "induction phi has no latch incoming"
    if any(i.op in _DAE_CU_OPS for i in hb.body):
        return None, "DAE op in loop header"
    if len(hb.body) != 1 or hb.body[0].op != "bin" \
            or hb.body[0].args[0] != "<":
        return None, "header is not a single `iv < bound` test"
    cond = hb.body[0].dest
    if hb.body[0].args[1] != iv:
        return None, "bound test does not compare the induction phi"
    bound = hb.body[0].args[2]
    if hb.term.kind != "cbr" or hb.term.cond != cond:
        return None, "header terminator is not the bound test"
    body_t, exit_t = hb.term.targets
    if body_t not in body_set or exit_t in body_set:
        return None, "bound test targets are not (body, exit)"

    region = [b for b in body_set if b != h]
    region_set = set(region)

    # -- region must be a DAG of plain blocks ending at the latch -----------
    for b in region:
        blk = fn.blocks[b]
        if blk.phis:
            return None, f"join phi in loop block {b}"
        if blk.term.kind == "ret":
            return None, f"loop block {b} returns"
        for t in blk.term.succs():
            if t not in region_set and t != h:
                return None, f"loop block {b} exits the loop mid-iteration"
        if h in blk.term.succs() and b != latch:
            return None, "multiple backedge sources"

    order = _topo(fn, region_set, body_t)
    if order is None or len(order) != len(region_set):
        return None, "loop body is not an acyclic single-entry region"

    # -- op inventory, unit-stride induction, def/use discipline ------------
    defs: Dict[str, str] = {}
    n_ops = 0
    loaded: Set[str] = set()
    stored_sites: Dict[str, int] = {}
    for b in order:
        for i in fn.blocks[b].body:
            n_ops += 1
            if i.op not in _VECTOR_OPS:
                return None, f"op {i.op!r} in {b} not vectorisable"
            if i.op == "bin" and i.args[0] not in _BINOP_EXPR:
                return None, f"binop {i.args[0]!r} in {b} not vectorisable"
            if i.op == "poison_st" and i.meta.get("pred_reg"):
                return None, f"steered poison in {b} (dynamic slot count)"
            if i.op == "load":
                loaded.add(i.array)
            elif i.op == "store":
                stored_sites[i.array] = stored_sites.get(i.array, 0) + 1
            if i.dest is not None:
                if i.dest in defs:
                    return None, f"{i.dest} multiply defined in loop body"
                defs[i.dest] = b
    if iv in defs or (isinstance(bound, str) and bound in defs):
        return None, "loop body redefines the induction variable or bound"
    bad_local = sorted(set(stored_sites) & loaded)
    if bad_local:
        return None, (f"local array {bad_local[0]} both loaded and stored "
                      f"in the loop (cross-iteration dependence)")
    multi = sorted(a for a, n in stored_sites.items() if n > 1)
    if multi:
        return None, (f"local array {multi[0]} stored at multiple sites "
                      f"(in-epoch write order not reconstructible)")
    if not _unit_increment(fn, region_set, nxt, iv):
        return None, "induction step is not `iv + 1`"
    leak = _region_use_outside(fn, region_set, set(defs), {nxt, cond})
    if leak:
        return None, f"loop value {leak} used outside the loop body"
    if _used_elsewhere(fn, cond, h):
        return None, "bound test value used beyond the header"

    # -- uniform request counts: forward DP over the region DAG -------------
    k_loads, k_stores, why = _slot_dp(fn, region_set, order, body_t, latch)
    if why is not None:
        return None, why

    fwd_chains, fwd_reasons = _chain_slots(fn, order, k_loads, k_stores)
    return UniformLoop(h, body_t, latch, exit_t, iv, bound, order,
                       k_loads, k_stores, n_ops, fwd_chains,
                       fwd_reasons), None


def _chain_slots(fn: Function, order: List[str],
                 k_loads: Dict[str, int], k_stores: Dict[str, int]
                 ) -> Tuple[Dict[str, int], Dict[str, str]]:
    """Classify associative store-update chains (the forwardable shape).

    For each decoupled array with exactly one store slot and at least one
    load slot per iteration, walk every committing store site's value
    back through the pure ``+``-spine of its def chain: a def that is a
    ``consume_ld`` of the same array contributes its slot, a ``+``
    recurses into both operands, and anything else (``*``, ``select``,
    loads of other arrays, loop-invariants) is an additive leaf that
    contributes nothing.  The array is a forwarding candidate exactly
    when every site reaches **one** common slot — the chain slot whose
    lane the vector driver subtracts to obtain the per-store delta.
    Non-``+`` dependence on *other* slots (spmv's ``y + v*x``) is fine:
    it only slows fixpoint convergence, never soundness, which rests on
    the driver's dynamic address/position checks.
    """
    region = set(order)
    defs: Dict[str, Any] = {}
    ld_slot: Dict[int, int] = {}
    produce_vals: Dict[str, List[Any]] = {}
    block_in: Dict[str, Dict[str, Tuple[int, int]]] = {order[0]: {}}
    for b in order:
        off = dict(block_in.get(b, {}))
        for i in fn.blocks[b].body:
            if i.dest is not None:
                defs[i.dest] = i
            if i.op == "consume_ld":
                ld, st = off.get(i.array, (0, 0))
                ld_slot[id(i)] = ld
                off[i.array] = (ld + 1, st)
            elif i.op in ("produce_st", "poison_st"):
                ld, st = off.get(i.array, (0, 0))
                off[i.array] = (ld, st + 1)
                if i.op == "produce_st":
                    produce_vals.setdefault(i.array, []).append(i.args[0])
        for t in fn.blocks[b].term.succs():
            if t in region:
                block_in.setdefault(t, off)

    def spine(v, a: str) -> Set[int]:
        if not isinstance(v, str):
            return set()
        i = defs.get(v)
        if i is None:
            return set()
        if i.op == "consume_ld" and i.array == a:
            return {ld_slot[id(i)]}
        if i.op == "bin" and i.args[0] == "+":
            return spine(i.args[1], a) | spine(i.args[2], a)
        return set()

    chains: Dict[str, int] = {}
    reasons: Dict[str, str] = {}
    for a in sorted(set(k_loads) | set(k_stores)):
        if not k_stores.get(a) or not k_loads.get(a):
            continue  # no in-epoch RAW possible, nothing to forward
        if k_stores[a] != 1:
            reasons[a] = (f"{k_stores[a]} store slots per iteration "
                          f"(not a single associative chain)")
            continue
        sites = produce_vals.get(a, [])
        if not sites:
            reasons[a] = "store slot never commits (all sites poison)"
            continue
        slots = [spine(v, a) for v in sites]
        if any(len(s) != 1 for s in slots) or len({next(iter(s))
                                                  for s in slots
                                                  if len(s) == 1}) != 1:
            reasons[a] = ("store value is not an additive update of "
                          "exactly one load slot")
            continue
        chains[a] = next(iter(slots[0]))
    return chains, reasons


def _topo(fn: Function, region: Set[str], entry: str) -> Optional[List[str]]:
    blk_ix = {b: i for i, b in enumerate(fn.blocks)}
    indeg = {b: 0 for b in region}
    for b in region:
        for t in fn.blocks[b].term.succs():
            if t in region:
                indeg[t] += 1
    if entry not in region or indeg[entry] != 0:
        return None
    ready = [entry]
    out: List[str] = []
    while ready:
        ready.sort(key=blk_ix.get)  # deterministic emission order
        b = ready.pop(0)
        out.append(b)
        for t in fn.blocks[b].term.succs():
            if t in region:
                indeg[t] -= 1
                if indeg[t] == 0:
                    ready.append(t)
    return out if len(out) == len(region) else None


def _unit_increment(fn: Function, region: Set[str], nxt: str,
                    iv: str) -> bool:
    for b in region:
        for i in fn.blocks[b].body:
            if i.dest == nxt:
                if i.op != "bin" or i.args[0] != "+":
                    return False
                other = (i.args[2] if i.args[1] == iv
                         else i.args[1] if i.args[2] == iv else None)
                if other is None:
                    return False
                return other == 1 or _is_const_one(fn, other)
    return False


def _is_const_one(fn: Function, name) -> bool:
    if not isinstance(name, str):
        return False
    for blk in fn.blocks.values():
        for i in blk.body:
            if i.dest == name:
                return i.op == "const" and i.args[0] == 1
    return False


def _region_use_outside(fn: Function, region: Set[str], defs: Set[str],
                        allowed: Set[str]) -> Optional[str]:
    watch = defs - allowed
    if not watch:
        return None
    for bname, blk in fn.blocks.items():
        if bname in region:
            continue
        for p in blk.phis:
            for v in (x for (_, x) in p.args):
                if v in watch:
                    return v
        for i in blk.body:
            for u in i.uses():
                if u in watch:
                    return u
        if blk.term.kind == "cbr" and blk.term.cond in watch:
            return blk.term.cond
    return None


def _used_elsewhere(fn: Function, name: str, home: str) -> bool:
    for bname, blk in fn.blocks.items():
        for p in blk.phis:
            if name in (v for (_, v) in p.args):
                return True
        for i in blk.body:
            if name in i.uses():
                return True
        if blk.term.kind == "cbr" and blk.term.cond == name \
                and bname != home:
            return True
    return False


def _slot_dp(fn: Function, region: Set[str], order: List[str], entry: str,
             latch: str):
    """Per-array request offsets must be path-invariant at every block."""
    block_in: Dict[str, Dict[str, Tuple[int, int]]] = {entry: {}}
    out_at: Dict[str, Dict[str, Tuple[int, int]]] = {}
    for b in order:
        if b not in block_in:
            return {}, {}, f"loop block {b} unreachable from the body entry"
        off = dict(block_in[b])
        for i in fn.blocks[b].body:
            if i.op == "consume_ld":
                ld, st = off.get(i.array, (0, 0))
                off[i.array] = (ld + 1, st)
            elif i.op in ("produce_st", "poison_st"):
                ld, st = off.get(i.array, (0, 0))
                off[i.array] = (ld, st + 1)
        out_at[b] = off
        for t in fn.blocks[b].term.succs():
            if t not in region:
                continue
            if t in block_in:
                if block_in[t] != off:
                    return {}, {}, (f"request counts diverge at join {t} "
                                    f"(paths are not iteration-uniform)")
            else:
                block_in[t] = off
    total = out_at.get(latch, {})
    k_loads = {a: ld for a, (ld, st) in sorted(total.items())}
    k_stores = {a: st for a, (ld, st) in sorted(total.items())}
    return k_loads, k_stores, None
