"""SSA-style mini-IR for the DAE speculation compiler (paper §3.2).

The IR models loop nests over named arrays — the domain of the paper's
benchmarks (graph/data analytics kernels).  It is deliberately small:

  * values are named virtual registers, defined once (SSA-ish; we relax strict
    dominance for transformation-inserted defs, see DESIGN.md §8),
  * ``phi`` nodes live at block heads and select on the *dynamic* predecessor,
  * memory is a set of named arrays; ``load``/``store`` address them by index,
  * each block ends in exactly one terminator: ``br``/``cbr``/``ret``,
  * decoupled (DAE) communication ops — ``send_ld``/``consume_ld``/
    ``send_st``/``produce_st``/``poison_st`` — are first-class so that the
    AGU/CU slices produced by :mod:`repro.core.decouple` are themselves
    ordinary IR functions, and the speculation/poisoning transforms
    (:mod:`repro.core.speculation`, :mod:`repro.core.poison`) are IR→IR.

``setreg``/``getreg`` provide mutable per-iteration steering flags — the
operational equivalent of Algorithm 3's ``phi(1, specBB)`` web (one flag per
speculation block, reset each iteration); see DESIGN.md §8.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Instructions
# ---------------------------------------------------------------------------

#: ops with a side effect on memory or a FIFO (never dead-code eliminated).
EFFECT_OPS = frozenset({
    "store", "send_ld", "consume_ld", "send_st", "produce_st", "poison_st",
    "setreg", "print",
})

#: ops that reference a named array.
MEMORY_OPS = frozenset({
    "load", "store", "send_ld", "consume_ld", "send_st", "produce_st",
    "poison_st",
})

#: AGU-side request ops (the paper's ``send_ld_addr`` / ``send_st_addr``).
REQUEST_OPS = frozenset({"send_ld", "send_st"})


@dataclass
class Instr:
    """One IR instruction.

    op/args conventions::

        const   dest = literal(args[0])
        bin     dest = args[0] <op args[1]> args[2]      (args[1:] are names)
        select  dest = args[1] if args[0] else args[2]
        phi     dest = select on dynamic predecessor; args = ((pred, name), ...)
        load    dest = array[args[0]]
        store   array[args[0]] = args[1]
        send_ld   AGU: request load  of array[args[0]]; meta['sync'] -> dest
        send_st   AGU: request store of array[args[0]]
        consume_ld  CU: dest = next load value of array (FIFO order)
        produce_st  CU: send store value args[0] for array (FIFO order)
        poison_st   CU: send poison token for array's next store request
        setreg  reg[args[0]] = args[1] (name) or literal meta['imm']
        getreg  dest = reg[args[0]]
    """

    op: str
    dest: Optional[str] = None
    args: Tuple[Any, ...] = ()
    array: Optional[str] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    # -- helpers -----------------------------------------------------------
    def uses(self) -> Tuple[str, ...]:
        """Names of SSA values this instruction reads."""
        if self.op == "const":
            return ()
        if self.op == "bin":
            return tuple(a for a in self.args[1:] if isinstance(a, str))
        if self.op == "phi":
            return tuple(v for (_, v) in self.args)
        if self.op == "setreg":
            return tuple(a for a in self.args[1:] if isinstance(a, str))
        if self.op == "getreg":
            return ()
        return tuple(a for a in self.args if isinstance(a, str))

    def is_effect(self) -> bool:
        return self.op in EFFECT_OPS

    def clone(self) -> "Instr":
        return Instr(self.op, self.dest, tuple(self.args), self.array,
                     copy.deepcopy(self.meta))

    def __repr__(self) -> str:  # compact printing for dumps/tests
        d = f"{self.dest} = " if self.dest else ""
        a = f" @{self.array}" if self.array else ""
        return f"{d}{self.op}{a} {list(self.args)}"


# Terminators -----------------------------------------------------------------


@dataclass
class Term:
    """Block terminator: ('br', tgt) | ('cbr', cond, t, f) | ('ret',)."""

    kind: str
    cond: Optional[str] = None
    targets: Tuple[str, ...] = ()

    @staticmethod
    def br(tgt: str) -> "Term":
        return Term("br", None, (tgt,))

    @staticmethod
    def cbr(cond: str, t: str, f: str) -> "Term":
        return Term("cbr", cond, (t, f))

    @staticmethod
    def ret() -> "Term":
        return Term("ret", None, ())

    def succs(self) -> Tuple[str, ...]:
        return self.targets

    def retarget(self, old: str, new: str) -> None:
        self.targets = tuple(new if t == old else t for t in self.targets)

    def clone(self) -> "Term":
        return Term(self.kind, self.cond, tuple(self.targets))

    def __repr__(self) -> str:
        if self.kind == "br":
            return f"br {self.targets[0]}"
        if self.kind == "cbr":
            return f"cbr {self.cond} ? {self.targets[0]} : {self.targets[1]}"
        return "ret"


# ---------------------------------------------------------------------------
# Blocks and functions
# ---------------------------------------------------------------------------


@dataclass
class Block:
    name: str
    phis: List[Instr] = field(default_factory=list)
    body: List[Instr] = field(default_factory=list)
    term: Optional[Term] = None
    #: transform-inserted block (poison/steering): transparent for dynamic
    #: phi-predecessor resolution in the interpreter and machine.
    synthetic: bool = False

    # -- builder sugar ------------------------------------------------------
    def _emit(self, instr: Instr) -> Instr:
        self.body.append(instr)
        return instr

    def const(self, dest: str, value: Any) -> str:
        self._emit(Instr("const", dest, (value,)))
        return dest

    def bin(self, dest: str, op: str, a: str, b: str) -> str:
        self._emit(Instr("bin", dest, (op, a, b)))
        return dest

    def select(self, dest: str, c: str, t: str, f: str) -> str:
        self._emit(Instr("select", dest, (c, t, f)))
        return dest

    def phi(self, dest: str, incoming: List[Tuple[str, str]]) -> str:
        self.phis.append(Instr("phi", dest, tuple(incoming)))
        return dest

    def load(self, dest: str, array: str, idx: str, **meta: Any) -> str:
        self._emit(Instr("load", dest, (idx,), array, dict(meta)))
        return dest

    def store(self, array: str, idx: str, val: str, **meta: Any) -> None:
        self._emit(Instr("store", None, (idx, val), array, dict(meta)))

    def br(self, tgt: str) -> None:
        self.term = Term.br(tgt)

    def cbr(self, cond: str, t: str, f: str) -> None:
        self.term = Term.cbr(cond, t, f)

    def ret(self) -> None:
        self.term = Term.ret()

    def instructions(self) -> Iterator[Instr]:
        yield from self.phis
        yield from self.body

    def __repr__(self) -> str:
        lines = [f"{self.name}:"]
        for i in self.instructions():
            lines.append(f"  {i!r}")
        lines.append(f"  {self.term!r}")
        return "\n".join(lines)


@dataclass
class Function:
    """A function: ordered blocks + declared arrays + integer params."""

    name: str
    params: Tuple[str, ...] = ()
    blocks: Dict[str, Block] = field(default_factory=dict)
    entry: str = "entry"
    arrays: Dict[str, int] = field(default_factory=dict)  # name -> length

    _uid: int = 0

    # -- construction -------------------------------------------------------
    def block(self, name: str) -> Block:
        if name in self.blocks:
            raise ValueError(f"duplicate block {name}")
        b = Block(name)
        self.blocks[name] = b
        return b

    def array(self, name: str, length: int) -> str:
        self.arrays[name] = length
        return name

    def fresh(self, stem: str) -> str:
        self._uid += 1
        return f"{stem}.{self._uid}"

    # -- queries -------------------------------------------------------------
    def succs(self, b: str) -> Tuple[str, ...]:
        return self.blocks[b].term.succs()

    def preds_map(self) -> Dict[str, List[str]]:
        preds: Dict[str, List[str]] = {b: [] for b in self.blocks}
        for b, blk in self.blocks.items():
            for s in blk.term.succs():
                preds[s].append(b)
        return preds

    def verify(self) -> None:
        """Structural sanity: terminators set, targets exist, defs unique."""
        defs: Dict[str, str] = {}
        for bname, blk in self.blocks.items():
            if blk.term is None:
                raise ValueError(f"block {bname} lacks a terminator")
            for t in blk.term.succs():
                if t not in self.blocks:
                    raise ValueError(f"block {bname} targets unknown {t}")
            for i in blk.instructions():
                if i.dest is not None:
                    if i.dest in defs and not i.meta.get("multi_def"):
                        raise ValueError(
                            f"{i.dest} defined in both {defs[i.dest]} and {bname}")
                    defs[i.dest] = bname

    def clone(self) -> "Function":
        f = Function(self.name, tuple(self.params), {}, self.entry,
                     dict(self.arrays))
        f._uid = self._uid
        for name, blk in self.blocks.items():
            nb = Block(name, [i.clone() for i in blk.phis],
                       [i.clone() for i in blk.body], blk.term.clone(),
                       blk.synthetic)
            f.blocks[name] = nb
        return f

    def dump(self) -> str:
        hdr = f"func {self.name}({', '.join(self.params)}) " \
              f"arrays={{{', '.join(f'{a}[{n}]' for a, n in self.arrays.items())}}}"
        return "\n".join([hdr] + [repr(self.blocks[b]) for b in self.blocks])

    # -- edits used by the transforms ----------------------------------------
    def split_edge(self, src: str, dst: str, name: Optional[str] = None) -> Block:
        """Insert a fresh empty block on the (src, dst) edge.

        phi nodes in ``dst`` are re-pointed at the new block.
        """
        name = name or self.fresh(f"{src}_{dst}")
        nb = self.block(name)
        nb.br(dst)
        self.blocks[src].term.retarget(dst, name)
        for p in self.blocks[dst].phis:
            p.args = tuple((name if blk == src else blk, v) for (blk, v) in p.args)
        return nb

    def retarget_phis(self, block: str, old_pred: str, new_pred: str) -> None:
        for p in self.blocks[block].phis:
            p.args = tuple((new_pred if blk == old_pred else blk, v)
                           for (blk, v) in p.args)


def function_from(obj: Any) -> Function:
    """Rebuild a :class:`Function` from any object shaped like one.

    ``obj`` needs the IR's attributes — ``name``, ``params``, ``entry``,
    ``arrays``, ``_uid`` and ``blocks[*].phis/body/term/synthetic``, with
    instructions carrying ``op/dest/args/array/meta`` and terminators
    ``kind/cond/targets`` — and nothing else, so a program built by
    another package with the same IR (the JAX reference's) carries across
    without that package being imported.  The copy shares no mutable
    state with ``obj``.
    """
    def instr(i: Any) -> Instr:
        return Instr(i.op, i.dest, tuple(i.args), i.array,
                     copy.deepcopy(dict(i.meta)))

    f = Function(obj.name, tuple(obj.params), {}, obj.entry,
                 dict(obj.arrays))
    f._uid = obj._uid
    for name, blk in obj.blocks.items():
        t = blk.term
        f.blocks[name] = Block(
            name, [instr(i) for i in blk.phis], [instr(i) for i in blk.body],
            None if t is None else Term(t.kind, t.cond, tuple(t.targets)),
            bool(blk.synthetic))
    return f


# ---------------------------------------------------------------------------
# Loop-nest builder
# ---------------------------------------------------------------------------


class LoopNest:
    """Compact builder for counted loop nests over a :class:`Function`.

    Collapses the entry/header/latch/exit wiring that every benchmark
    kernel (and every codegen test fixture) would otherwise hand-roll::

        f = Function("hist"); f.array("H", 32)
        nest = LoopNest(f)                    # opens `entry`, pools 0/1
        b = nest.enter("i", nest.const(n, "N"))
        b.load("hv", "H", "i")                # ... loop body ...
        b.br(nest.latch)                      # paths end at the latch
        nest.finish()                         # wires cbr/latch/exit, verifies

    * ``const`` pools literals into the entry block (one ``const`` per
      distinct value, in first-use order — ``zero``/``one`` are pre-pooled
      for the loop plumbing).
    * ``enter`` opens a counted loop ``for var in range(bound)``: a header
      with the ``var`` phi and bound check, a latch with the increment and
      backedge, and the returned open body block.  Nested ``enter`` calls
      (from inside a body block) chain automatically: an inner header's
      exit edge targets the enclosing latch.
    * The first loop uses the canonical ``header``/``body``/``latch``
      names; any further loop (nested *or* a sequential sibling) prefixes
      them with the loop variable.
    * **Sequential sibling loops** (two loops at the same nesting level,
      the second entered when the first exhausts) wire through the
      header-exit edge: close the first loop with
      ``close(exit_to=<next header name>)`` and enter the second with
      ``pred=<first header name>`` — ``pred`` names the already-wired
      predecessor block for the induction phi, so ``enter`` skips the
      ``frm.br`` edge it would otherwise create.  ``header_name(var)``
      predicts the block names so the hand-off can be wired before the
      second loop exists.
    """

    def __init__(self, fn: Function, entry: str = "entry"):
        self.fn = fn
        self.entry = fn.block(entry)
        self._pool: Dict[Any, str] = {}
        self._stack: List[Dict[str, Any]] = []
        self._closed: bool = False
        self.const(0, "zero")
        self.const(1, "one")

    # -- const pooling -------------------------------------------------------
    def const(self, value: Any, name: Optional[str] = None) -> str:
        """Pooled constant: emitted once in the entry block, reused after."""
        if value in self._pool:
            return self._pool[value]
        if name is None:
            name = f"c{value}".replace("-", "m")
        if name in self._pool.values():
            name = self.fn.fresh(name)
        self.entry.const(name, value)
        self._pool[value] = name
        return name

    # -- loops ---------------------------------------------------------------
    def header_name(self, var: str) -> str:
        """Predict the header block name ``enter(var, ...)`` would use now.

        Lets a sequential hand-off be wired before the next loop exists:
        ``nest.close(exit_to=nest.header_name("j"))`` then
        ``nest.enter("j", ..., pred=prev_header)``.
        """
        pre = "" if "header" not in self.fn.blocks else f"{var}_"
        return f"{pre}header"

    def enter(self, var: str, bound: str,
              frm: Optional[Block] = None,
              pred: Optional[str] = None) -> Block:
        """Open ``for var in range(bound)``; returns the open body block.

        ``frm`` is the block that enters the loop (default: the entry
        block for the outermost loop, the enclosing body block for nested
        ones).  ``pred`` instead names an *already-wired* predecessor — a
        block whose terminator already targets this loop's header (the
        sequential-sibling hand-off) — so no ``frm.br`` edge is added and
        the induction phi takes its zero from ``pred``.
        """
        # the first loop claims the canonical unprefixed names; every
        # later loop — nested or sequential sibling — prefixes with `var`
        pre = "" if "header" not in self.fn.blocks else f"{var}_"
        header = self.fn.block(f"{pre}header")
        body = self.fn.block(f"{pre}body")
        # the latch is built now (so body paths can branch to it) but only
        # *registered* at close(), keeping the block order of the
        # conventional hand-rolled layout: body blocks first, latch after
        latch = Block(f"{pre}latch")
        if pred is None:
            if frm is None:
                frm = (self.entry if not self._stack
                       else self._stack[-1]["body"])
            frm.br(header.name)
            pred = frm.name
        header.phi(var, [(pred, self._pool[0]),
                         (latch.name, f"{var}_next")])
        cond = "c" if pre == "" else f"{var}_c"
        header.bin(cond, "<", var, bound)
        latch.bin(f"{var}_next", "+", var, self._pool[1])
        latch.br(header.name)
        self._stack.append({"var": var, "header": header, "body": body,
                            "latch": latch, "cond": cond})
        return body

    @property
    def latch(self) -> str:
        """Name of the innermost latch (the branch target for body paths)."""
        return self._stack[-1]["latch"].name

    @property
    def header(self) -> str:
        """Name of the innermost header (the sibling hand-off predecessor)."""
        return self._stack[-1]["header"].name

    def close(self, exit_to: Optional[str] = None) -> None:
        """Close the innermost loop: wire its header's exit edge to
        ``exit_to`` (default: the enclosing latch, or ``exit``)."""
        top = self._stack.pop()
        if exit_to is None:
            exit_to = self._stack[-1]["latch"].name if self._stack else "exit"
        top["header"].cbr(top["cond"], top["body"].name, exit_to)
        latch = top["latch"]
        if latch.name in self.fn.blocks:
            raise ValueError(f"block {latch.name} shadowed before close")
        self.fn.blocks[latch.name] = latch

    def finish(self, verify: bool = True) -> Function:
        """Close all open loops, emit the ``exit`` block, and verify."""
        if self._closed:
            raise ValueError("LoopNest.finish called twice")
        while self._stack:
            self.close()
        self.fn.block("exit").ret()
        self._closed = True
        if verify:
            self.fn.verify()
        return self.fn
