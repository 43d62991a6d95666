"""CLI driver: ``python -m repro_torch.verify <workload ...|--all>``.

Runs the standalone verifier over compiled benchmark workloads (and a
seeded ``randprog`` sweep), then cross-checks its verdict against the
``repro_torch.codegen`` classifier — the *differential* that gives the second
implementation teeth:

* a soundness finding on a program codegen happily classifies, or a
  clean verdict on one codegen refuses, is an ``X01`` split and a
  nonzero exit;
* the schedule rules must agree exactly: the verifier's ``D01`` finding
  iff ``analysis.agu_class == AGU_VALUE_DEP``, and the verifier's
  path-enumerated chain slots iff the classifier's offset-DP
  ``fwd_chains`` — same verdict from two different algorithms.

This module (and the test suite) is the **only** place ``repro_torch.verify``
code may import ``repro_torch.codegen`` — the analysis modules themselves are
codegen-free so the verifier cannot inherit the bugs it audits.

Exit status 0 only when every selected check is clean and, with
``--budget``, the whole run fits the time budget.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

from ..core import randprog
from ..core.cfg import CFGInfo
from ..core.pipeline import compile_spec
from . import decoupling, mutate, soundness, verify_compiled, verify_function
from .rules import Diag


def differential(comp, memory: Optional[dict] = None
                 ) -> Tuple[List[Diag], List[Diag]]:
    """Verify one compiled pair and diff the verdict against codegen.

    Returns ``(verifier_diags, splits)`` where ``splits`` is the list of
    ``X01`` findings — places the two independent analyses disagree.
    Imports codegen locally (see the module docstring).
    """
    from ..codegen import analysis

    diags = verify_compiled(comp, memory)
    splits: List[Diag] = []
    info = analysis.analyze(comp)

    codegen_ok = info.stream_reason is None
    if bool(soundness(diags)) and codegen_ok:
        splits.append(Diag(
            "X01-verifier-classifier-split", "soundness",
            f"verifier reports {[d.rule for d in soundness(diags)]} but "
            f"the codegen classifier raises no objection"))

    d01 = any(d.rule == "D01-agu-value-dependent" for d in diags)
    cls = info.agu_class == analysis.AGU_VALUE_DEP
    if d01 != cls:
        splits.append(Diag(
            "X01-verifier-classifier-split", "agu",
            f"verifier D01={d01} but codegen agu_class="
            f"{info.agu_class!r} — stream-schedule verdicts disagree"))

    if info.uniform_loops is not None and not soundness(diags):
        cm = decoupling.chain_map(comp.cu, CFGInfo(comp.cu))
        for ul in info.uniform_loops:
            mine = {a: s for a, (s, _why) in cm.get(ul.header, {}).items()
                    if s is not None}
            if mine != dict(ul.fwd_chains):
                splits.append(Diag(
                    "X01-verifier-classifier-split", f"cu:{ul.header}",
                    f"chain slots disagree: verifier {mine} vs "
                    f"classifier {dict(ul.fwd_chains)}"))
    return diags, splits


def _report(label: str, diags: List[Diag], splits: List[Diag]) -> bool:
    """Print one program's verdict; True when it counts as dirty."""
    findings = soundness(diags) + splits
    sched = [d for d in diags if d not in soundness(diags)]
    note = (" [" + ", ".join(d.rule for d in sched) + "]") if sched else ""
    if findings:
        print(f"FAIL {label}{note}")
        for d in findings:
            print(f"     {d}")
        return True
    print(f"ok   {label}{note}")
    return False


def _run_workloads(names: List[str], with_mutants: bool) -> Tuple[int, int]:
    """Verify + differential each named workload; return (ran, dirty)."""
    from ..bench_irregular import ALL

    dirty = 0
    for name in names:
        case = ALL[name]()
        comp = compile_spec(case.fn, case.decoupled)
        diags, splits = differential(comp, case.memory)
        dirty += _report(f"workload/{name}", diags, splits)
        if with_mutants:
            results = mutate.check_mutants(comp, case.memory)
            missed = [(k, r) for k, r, caught in results if not caught]
            for k, r in missed:
                print(f"FAIL workload/{name} mutant {k}: "
                      f"expected {r} not reported")
            dirty += len(missed)
            if results:
                print(f"     {len(results)} mutants, "
                      f"{len(results) - len(missed)} caught")
    return len(names), dirty


def _run_randprog(n: int) -> Tuple[int, int]:
    """Sweep seeds 0..n-1 over both generator variants; return (ran, dirty)."""
    ran = dirty = 0
    for variant, kw in (("plain", {}), ("assoc", {"assoc_chains": True})):
        for seed in range(n):
            g = randprog.generate(seed, **kw)
            comp = compile_spec(g.fn, g.decoupled)
            diags, splits = differential(comp, g.memory)
            ran += 1
            findings = soundness(diags) + splits
            if findings:
                dirty += _report(f"randprog/{variant}/{seed}", diags, splits)
    print(f"ok   randprog sweep: {ran} programs, {dirty} dirty")
    return ran, dirty


def _run_negative(n: int) -> Tuple[int, int]:
    """Negative corpus: each known-unsound program must be caught."""
    import random

    ran = dirty = 0
    for seed in range(n):
        g = randprog.generate(seed, negative=True)
        ran += 1
        label = f"negative/{seed} ({g.expect_rule})"
        if g.mutate:
            comp = compile_spec(g.fn, g.decoupled)
            m = mutate._clone(comp)
            assert mutate._APPLY[g.mutate](m, random.Random(seed))
            diags = verify_compiled(m, g.memory)
        else:
            diags = verify_function(g.fn)
            try:  # codegen side of the differential: must refuse too
                compile_spec(g.fn, g.decoupled)
                print(f"FAIL {label}: compile_spec accepted it")
                dirty += 1
                continue
            except ValueError:
                pass
        if not any(d.rule == g.expect_rule for d in diags):
            print(f"FAIL {label}: got {[d.rule for d in diags]}")
            dirty += 1
    print(f"ok   negative corpus: {ran} programs, {dirty} missed")
    return ran, dirty


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point; returns the process exit status."""
    from ..bench_irregular import ALL

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="standalone DAE speculation-soundness verifier")
    p.add_argument("workloads", nargs="*", choices=[[], *sorted(ALL)],
                   help="benchmark workloads to verify")
    p.add_argument("--all", action="store_true",
                   help="verify every benchmark workload")
    p.add_argument("--randprog", type=int, default=0, metavar="N",
                   help="also sweep N randprog seeds (both variants)")
    p.add_argument("--negative", type=int, default=0, metavar="N",
                   help="also run N known-unsound negative programs")
    p.add_argument("--mutants", action="store_true",
                   help="mutation-test the verifier on each workload")
    p.add_argument("--budget", type=float, default=None, metavar="SECONDS",
                   help="fail if the whole run exceeds this wall time")
    args = p.parse_args(argv)

    names = sorted(ALL) if args.all else list(args.workloads)
    if not names and not args.randprog and not args.negative:
        p.error("nothing to verify: name workloads, or pass --all")

    t0 = time.perf_counter()
    ran = dirty = 0
    for r, d in (_run_workloads(names, args.mutants),
                 _run_randprog(args.randprog) if args.randprog else (0, 0),
                 _run_negative(args.negative) if args.negative else (0, 0)):
        ran += r
        dirty += d
    dt = time.perf_counter() - t0

    status = "DIRTY" if dirty else "clean"
    print(f"verify: {ran} programs {status} "
          f"({dirty} findings) in {dt:.2f}s")
    if args.budget is not None and dt > args.budget:
        print(f"FAIL budget: {dt:.2f}s > {args.budget:.2f}s")
        return 1
    return 1 if dirty else 0


if __name__ == "__main__":
    sys.exit(main())
