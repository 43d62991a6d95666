"""End-to-end compilation pipeline: source IR → {STA, DAE, SPEC, ORACLE}.

Mirrors the paper's §8.1.1 baselines:

* **STA**    — the original function under the static-scheduling model.
* **DAE**    — decoupled slices, no speculation: LoD control dependencies
               leave sync round-trips in the AGU (Fig. 1b).
* **SPEC**   — decoupled + Algorithm 1 hoisting + Algorithms 2/3 poisoning
               (+ §5.3 merging): the paper's contribution (Fig. 1c).
* **ORACLE** — LoD branches constant-folded away in the *input* (requests
               made unconditional), then plain DAE.  Results are wrong, by
               design; only the cycle count is meaningful (perf upper bound).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np

from . import decouple as dec
from . import lod as lod_mod
from . import machine
from . import poison as poison_mod
from . import speculation as spec_mod
from .cfg import CFGInfo
from .interp import run as interp_run
from .ir import Function


@dataclass
class CompiledDAE:
    agu: Function
    cu: Function
    spec: Optional[spec_mod.SpecResult] = None
    poison_stats: Optional[poison_mod.PoisonStats] = None
    lod: Optional[lod_mod.LoDInfo] = None
    #: arrays served by a DU/LSQ (recorded so executable backends need not
    #: re-derive the set from the slices)
    decoupled: Set[str] = None  # type: ignore[assignment]
    #: populated by the frontend compile cache (repro_torch.frontend.cache):
    #: {"outcome": "cold"|"warm"|"stale", "key": ..., counters...}
    cache_stats: Optional[Dict[str, Any]] = None

    # -- executable codegen hooks (see repro_torch.codegen) -----------------
    def codegen(self, target: str = "torch") -> Dict[str, Optional[str]]:
        """Emit the per-slice executable sources for ``target``."""
        from .. import codegen
        return codegen.lower(self, target)

    def run_generated(self, memory: Dict[str, Any],
                      params: Optional[Dict[str, Any]] = None,
                      target: str = "torch", **kw):
        """Run the generated kernel for ``target`` against ``memory``
        (mutated in place); falls back to the coupled interpreter when the
        target cannot lower this slice pair.  Returns a
        :class:`repro_torch.codegen.CodegenRun`."""
        from .. import codegen
        return codegen.run(self, memory, params, target, **kw)


def compile_dae(fn: Function, decoupled: Set[str]) -> CompiledDAE:
    """Plain decoupling (the paper's DAE baseline)."""
    src = fn.clone()
    agu, cu = dec.decouple(src, decoupled)
    info = lod_mod.analyze(src, decoupled)
    return CompiledDAE(agu, cu, lod=info, decoupled=set(decoupled))


def compile_spec(fn: Function, decoupled: Set[str]) -> CompiledDAE:
    """Decoupling + the paper's speculation transforms (§5)."""
    src = fn.clone()
    lod_mod.tag_mids(src)
    info = lod_mod.analyze(src, decoupled)

    agu = src.clone()
    agu.name = fn.name + ".agu"
    cu = src.clone()
    cu.name = fn.name + ".cu"
    agu, cu = dec.decouple_slices(agu, cu, decoupled)

    spec = spec_mod.speculate(agu, cu, info)
    array_of = {mid: instr.array
                for bname, blk in src.blocks.items()
                for instr in blk.body
                if instr.meta.get("mid") is not None
                for mid in [instr.meta["mid"]]}
    stats = poison_mod.poison_cu(cu, info.cfg, spec, array_of)
    dec.dce(cu)
    dec.finalize_agu(agu)
    return CompiledDAE(agu, cu, spec=spec, poison_stats=stats, lod=info,
                       decoupled=set(decoupled))


def compile_oracle(fn: Function, decoupled: Set[str]) -> CompiledDAE:
    """Fold every LoD branch toward its request-heavy side, then DAE."""
    src = fn.clone()
    info = lod_mod.analyze(src, decoupled)
    cfg = info.cfg
    for bname in info.tainted_branches:
        blk = src.blocks[bname]
        if blk.term.kind != "cbr":
            continue
        t0, t1 = blk.term.targets
        n0 = _reachable_requests(src, cfg, t0, decoupled)
        n1 = _reachable_requests(src, cfg, t1, decoupled)
        keep = t0 if n0 >= n1 else t1
        blk.br(keep)
    return compile_dae(src, decoupled)


def _reachable_requests(fn: Function, cfg: CFGInfo, start: str,
                        decoupled: Set[str]) -> int:
    seen, stack, n = {start}, [start], 0
    while stack:
        b = stack.pop()
        n += sum(1 for i in fn.blocks[b].body
                 if i.op in ("load", "store") and i.array in decoupled)
        for s in cfg.forward_succs(b):
            if s not in seen:
                seen.add(s)
                stack.append(s)
    return n


# ---------------------------------------------------------------------------
# Running
# ---------------------------------------------------------------------------


@dataclass
class VariantRun:
    name: str
    cycles: int
    memory: Dict[str, np.ndarray]
    result: Any = None


def run_all(fn: Function, decoupled: Set[str],
            memory: Dict[str, np.ndarray],
            params: Optional[Dict[str, Any]] = None,
            cfg: Optional[machine.MachineConfig] = None,
            variants: Tuple[str, ...] = ("ref", "sta", "dae", "spec",
                                         "oracle"),
            ) -> Dict[str, VariantRun]:
    """Compile and simulate the requested variants on copies of ``memory``."""
    cfg = cfg or machine.MachineConfig()
    out: Dict[str, VariantRun] = {}

    if "ref" in variants:  # the oracle-of-oracles: pure interpreter
        mem = {k: v.copy() for k, v in memory.items()}
        tr = interp_run(fn, mem, params)
        out["ref"] = VariantRun("ref", tr.instr_count, mem, tr)

    if "sta" in variants:
        mem = {k: v.copy() for k, v in memory.items()}
        r = machine.run_sta(fn, mem, params, cfg)
        out["sta"] = VariantRun("sta", r.cycles, mem, r)

    for name in ("dae", "spec", "oracle"):
        if name not in variants:
            continue
        comp = {"dae": compile_dae, "spec": compile_spec,
                "oracle": compile_oracle}[name](fn, decoupled)
        mem = {k: v.copy() for k, v in memory.items()}
        r = machine.run_dae(comp.agu, comp.cu, mem, decoupled, params, cfg)
        run = VariantRun(name, r.cycles, mem, r)
        run.compiled = comp  # type: ignore[attr-defined]
        out[name] = run
    return out
