"""Composable DAE programs: record a loop-nest AST, lower via LoopNest.

A :class:`Program` records statements (``const``/``load``/``store``/
``bin``/``select``/``update``) and structure (``range_loop``/``cond``)
at composition time, then replays the recording through
:class:`repro.core.ir.LoopNest` on :meth:`Program.build`.  Because the
replay drives the *same* builder the hand-rolled kernels use, in the
same order, a frontend re-expression of a kernel lowers to IR that is
byte-identical to its hand-rolled twin (``Function.dump()`` equality —
the contract ``tests/test_frontend.py`` pins for hist/spmv/sort).

Lowering contract (what the recording replays to):

* constants pool into the entry block in first-use order (``zero``/
  ``one`` pre-pooled, exactly as ``LoopNest`` does);
* ``range_loop`` opens a counted loop; the first loop claims the
  canonical ``header``/``body``/``latch`` names, later loops — nested or
  sequential — prefix them with the loop variable;
* sequential sibling loops hand off through the previous loop's
  header-exit edge (no join block);
* a ``cond`` that *ends* its sequence branches straight back to the
  continuation target (the enclosing latch or ``exit``) — the shape of
  every hand-rolled bench; a ``cond`` followed by more statements gets
  a join block.

Block and value names are caller-chosen ("named terminals") so dumps are
stable and human-auditable; the builder rejects collisions instead of
renaming behind the caller's back.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from ..core.ir import Block, Function, LoopNest
from ..core.pipeline import (CompiledDAE, compile_dae, compile_oracle,
                             compile_spec)

Operand = Union[str, int]


class FrontendError(ValueError):
    """Composition-time misuse of the frontend API."""


def dae(name: str, arrays: Optional[Dict[str, int]] = None,
        params: Sequence[str] = ()) -> "Program":
    """Open a program recording: ``p = dae("hist", arrays={"H": 32})``."""
    return Program(name, arrays, params)


class Program:
    """A recorded DAE program; see the module docstring for the contract."""

    def __init__(self, name: str, arrays: Optional[Dict[str, int]] = None,
                 params: Sequence[str] = ()):
        self.name = name
        self._arrays: Dict[str, int] = {
            a: int(n) for a, n in (arrays or {}).items()}
        self.params: Tuple[str, ...] = tuple(params)
        self._top: List[tuple] = []
        self._seq: List[List[tuple]] = [self._top]
        # mirror LoopNest's pre-pooled loop-plumbing constants
        self._cpool: Dict[Any, str] = {0: "zero", 1: "one"}
        self._upd = 0
        self._fn: Optional[Function] = None

    # -- declarations --------------------------------------------------------
    def array(self, name: str, length: int) -> str:
        self._arrays[name] = int(length)
        return name

    # -- scalar statements ---------------------------------------------------
    def _record(self, stmt: tuple) -> None:
        if self._fn is not None:
            raise FrontendError("program already lowered; Program recordings "
                                "are single-shot (build a new one)")
        self._seq[-1].append(stmt)

    def const(self, value: Any, name: Optional[str] = None) -> str:
        """Pooled constant (one per distinct value, first-use order)."""
        if value in self._cpool:
            return self._cpool[value]
        if name is None:
            name = f"c{value}".replace("-", "m")
        if name in self._cpool.values():
            raise FrontendError(f"const name {name!r} already pools "
                                f"{[v for v, n in self._cpool.items() if n == name][0]!r}")
        self._cpool[value] = name
        self._record(("const", value, name))
        return name

    def _operand(self, x: Operand) -> str:
        """Names pass through; int literals pool as constants."""
        return self.const(x) if isinstance(x, int) else x

    def load(self, dest: str, array: str, idx: Operand) -> str:
        self._record(("load", dest, array, self._operand(idx)))
        return dest

    def store(self, array: str, idx: Operand, val: Operand) -> None:
        self._record(("store", array, self._operand(idx), self._operand(val)))

    def bin(self, dest: str, op: str, a: Operand, b: Operand) -> str:
        self._record(("bin", dest, op, self._operand(a), self._operand(b)))
        return dest

    def select(self, dest: str, c: str, t: Operand, f: Operand) -> str:
        self._record(("select", dest, c, self._operand(t), self._operand(f)))
        return dest

    def update(self, array: str, idx: Operand, value: Operand,
               op: str = "+", load: Optional[str] = None,
               dest: Optional[str] = None) -> str:
        """Read-modify-write sugar: ``array[idx] = array[idx] <op> value``."""
        k = self._upd
        self._upd += 1
        idx = self._operand(idx)
        cur = self.load(load or f"{array.lower()}_old{k}", array, idx)
        new = self.bin(dest or f"{array.lower()}_new{k}", op, cur, value)
        self.store(array, idx, new)
        return new

    # -- structure -----------------------------------------------------------
    def range_loop(self, var: str, bound: Operand) -> "_LoopCtx":
        """``with p.range_loop("i", p.const(n, "N")): ...``"""
        return _LoopCtx(self, var, self._operand(bound))

    def cond(self, pred: str, then: str = "then",
             join: Optional[str] = None) -> "_CondCtx":
        """``with p.cond("p", then="then"): ...`` — optional
        ``.orelse(name)`` arm; ``join`` names the join block when the
        cond is *not* the last statement of its sequence."""
        return _CondCtx(self, pred, then, join)

    # -- lowering ------------------------------------------------------------
    def build(self, verify: bool = False) -> Function:
        """Replay the recording through LoopNest; memoised.

        ``verify=True`` additionally runs the source-level
        :func:`repro_torch.verify.verify_function` pass (IR
        well-formedness, reducible CFG) on the lowered nest and raises
        :class:`repro_torch.verify.VerifyError` on any finding.
        """
        if self._fn is None:
            if len(self._seq) != 1:
                raise FrontendError("unclosed range_loop/cond recording")
            f = Function(self.name, tuple(self.params))
            for a, n in self._arrays.items():
                f.array(a, n)
            nest = LoopNest(f)
            self._lower_seq(self._top, nest, nest.entry, "exit")
            nest.finish()
            self._fn = f
        if verify:
            from .. import verify as verify_mod
            diags = verify_mod.verify_function(self._fn)
            if diags:
                raise verify_mod.VerifyError(diags)
        return self._fn

    def _lower_seq(self, stmts: List[tuple], nest: LoopNest,
                   cur: Optional[Block], cont: str) -> None:
        """Lower one statement sequence; wires every path to ``cont``.

        ``cur`` is the open block statements emit into; it becomes None
        while a just-lowered loop is pending (still open on the nest
        stack) — the loop's header-exit edge is wired once the *next*
        structure is known (sibling loop, continuation block, or
        ``cont`` at sequence end).
        """
        f = nest.fn
        pending: Optional[Dict[str, str]] = None  # {"header","var"} of open loop
        last = len(stmts) - 1
        for n, st in enumerate(stmts):
            kind = st[0]
            if kind == "const":
                nest.const(st[1], st[2])
                continue
            if kind == "loop":
                _, var, bound, body = st
                if pending is not None:
                    nest.close(exit_to=nest.header_name(var))
                    b = nest.enter(var, bound, pred=pending["header"])
                else:
                    b = nest.enter(var, bound, frm=cur)
                hdr = nest.header
                self._lower_seq(body, nest, b, nest.latch)
                pending = {"header": hdr, "var": var}
                cur = None
                continue
            if pending is not None:
                # ops/cond after a loop: land them in a continuation block
                name = f"{pending['var']}_done"
                if name in f.blocks:
                    name = f.fresh(name)
                nest.close(exit_to=name)
                cur = f.block(name)
                pending = None
            if kind == "cond":
                node = st[1]
                if node["then"] is None:
                    raise FrontendError("cond recorded without a body")
                if n == last:
                    tgt, join = cont, None
                else:
                    join = node["join"] or f"{node['then_name']}_join"
                    if join in f.blocks:
                        join = f.fresh(join)
                    tgt = join
                false_tgt = (node["else_name"]
                             if node["els"] is not None else tgt)
                cur.cbr(node["pred"], node["then_name"], false_tgt)
                tb = f.block(node["then_name"])
                self._lower_seq(node["then"], nest, tb, tgt)
                if node["els"] is not None:
                    eb = f.block(node["else_name"])
                    self._lower_seq(node["els"], nest, eb, tgt)
                cur = f.block(join) if join is not None else None
                continue
            if kind == "load":
                cur.load(st[1], st[2], st[3])
            elif kind == "store":
                cur.store(st[1], st[2], st[3])
            elif kind == "bin":
                cur.bin(st[1], st[2], st[3], st[4])
            elif kind == "select":
                cur.select(st[1], st[2], st[3], st[4])
            else:  # pragma: no cover - recording is internal
                raise FrontendError(f"unknown statement {kind!r}")
        if pending is not None:
            nest.close(exit_to=cont)
        elif cur is not None:
            if cur.term is not None:
                raise FrontendError("statements after a terminal cond")
            cur.br(cont)

    # -- identity ------------------------------------------------------------
    def signature(self) -> str:
        """Canonical text of the recording — the cache-key payload."""
        def enc(stmts):
            out = []
            for st in stmts:
                if st[0] == "loop":
                    out.append(("loop", st[1], st[2], enc(st[3])))
                elif st[0] == "cond":
                    d = st[1]
                    out.append(("cond", d["pred"], d["then_name"],
                                enc(d["then"]), d["else_name"],
                                enc(d["els"]) if d["els"] is not None
                                else None, d["join"]))
                else:
                    out.append(st)
            return tuple(out)

        return repr((self.name, tuple(sorted(self._arrays.items())),
                     self.params, enc(self._top)))

    # -- compilation ---------------------------------------------------------
    def compile(self, decoupled: Set[str], mode: str = "spec",
                cache: Any = None, verify: bool = False) -> CompiledDAE:
        """Lower and compile to a :class:`CompiledDAE`.

        ``mode`` is ``"spec"`` (decouple + speculate + poison, the
        paper's contribution), ``"dae"`` (plain decoupling) or
        ``"oracle"``.  ``cache``: a
        :class:`repro_torch.frontend.cache.CompileCache`, ``None`` for the
        ambient default (persistent iff ``DAE_CACHE_DIR`` is set), or
        ``False`` to force cache-off.

        ``verify=True`` runs the standalone soundness verifier
        (:func:`repro_torch.verify.verify_compiled`) on the compiled pair
        and raises :class:`repro_torch.verify.VerifyError` on any
        soundness finding.  Cached compiles store the verdict in the
        payload (keyed on the rule-registry version), so warm hits replay
        it without re-running the pass.
        """
        comps = {"spec": compile_spec, "dae": compile_dae,
                 "oracle": compile_oracle}
        if mode not in comps:
            raise FrontendError(f"unknown mode {mode!r} "
                                f"(expected one of {sorted(comps)})")
        from .cache import resolve_cache
        cc = resolve_cache(cache)
        fn = self.build()
        if cc is None:
            comp = comps[mode](fn, set(decoupled))
            if verify:
                from .. import verify as verify_mod
                bad = verify_mod.soundness(verify_mod.verify_compiled(comp))
                if bad:
                    raise verify_mod.VerifyError(bad)
            return comp
        return cc.compile(self, fn, set(decoupled), mode, comps[mode],
                          verify=verify)


class _LoopCtx:
    """``with p.range_loop(var, bound) as v:`` — records a loop node."""

    def __init__(self, p: Program, var: str, bound: str):
        self.p, self.var, self.bound = p, var, bound

    def __enter__(self) -> str:
        self.p._seq.append([])
        return self.var

    def __exit__(self, et, ev, tb) -> bool:
        body = self.p._seq.pop()
        if et is None:
            self.p._record(("loop", self.var, self.bound, body))
        return False


class _CondCtx:
    """``with p.cond(pred, then="then"):`` — records a cond node; chain
    ``.orelse(name)`` directly after the then-arm for a false arm."""

    def __init__(self, p: Program, pred: str, then_name: str,
                 join: Optional[str]):
        self.p = p
        self.node: Dict[str, Any] = {
            "pred": pred, "then_name": then_name, "then": None,
            "else_name": None, "els": None, "join": join}

    def __enter__(self) -> "_CondCtx":
        if self.node["then"] is not None:
            raise FrontendError("cond body already recorded")
        self.p._seq.append([])
        return self

    def __exit__(self, et, ev, tb) -> bool:
        body = self.p._seq.pop()
        if et is None:
            self.node["then"] = body
            self.p._record(("cond", self.node))
        return False

    def orelse(self, name: str = "else") -> "_ElseCtx":
        return _ElseCtx(self.p, self.node, name)


class _ElseCtx:
    def __init__(self, p: Program, node: Dict[str, Any], name: str):
        self.p, self.node, self.name = p, node, name

    def __enter__(self) -> "_ElseCtx":
        seq = self.p._seq[-1]
        if not (seq and seq[-1][0] == "cond" and seq[-1][1] is self.node):
            raise FrontendError("orelse must directly follow its cond body")
        if self.node["els"] is not None:
            raise FrontendError("cond else-arm already recorded")
        self.node["else_name"] = self.name
        self.p._seq.append([])
        return self

    def __exit__(self, et, ev, tb) -> bool:
        body = self.p._seq.pop()
        if et is None:
            self.node["els"] = body
        return False
