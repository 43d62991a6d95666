"""The port's soundness verifier (repro_torch.verify) against the JAX
package's (repro.verify), on the CPU.

* **diagnostics** — ``verify_function`` on every workload's source nest
  and ``verify_compiled`` on its DAE and SPEC pairs give the reference's
  findings, rule, site and detail alike, and the port's differential
  against its own codegen classifier is clean;
* **mutants** — ``mutate.mutants(comp, seed)`` yields the same kinds with
  the same expected rules, and the verifier reports the same findings on
  each mutant; the hand-built steered pair and the negative corpus alike;
* **CLI** — ``python -m repro_torch.verify`` as a subprocess exits 0 and
  prints the reference CLI's report line for line (the run time aside);
* **independence** — the analysis modules import no codegen module.

Programs are carried across with :func:`repro_torch.core.ir.function_from`.
"""
import os
import random
import re
import subprocess
import sys

import pytest

import repro.verify as rverify
import repro_torch.verify as verify
from repro.bench_irregular import ALL as R_ALL
from repro.core import pipeline as rpipeline
from repro.core import randprog as rrandprog
from repro.verify import mutate as rmutate
from repro_torch.core import pipeline
from repro_torch.core.ir import function_from
from repro_torch.verify import mutate
from repro_torch.verify.__main__ import differential
from test_verify import _steered_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src", "repro_torch", "verify")


def _diags(diags):
    return [(d.rule, d.site, d.detail) for d in diags]


class _Pair:
    """A bare AGU/CU pair, as the verifier takes it."""

    def __init__(self, agu, cu):
        self.agu, self.cu = agu, cu


def _both(name, variant="spec"):
    case = R_ALL[name]()
    rcomp = getattr(rpipeline, f"compile_{variant}")(case.fn, case.decoupled)
    tcomp = getattr(pipeline, f"compile_{variant}")(function_from(case.fn),
                                                    case.decoupled)
    return case, rcomp, tcomp


@pytest.mark.parametrize("variant", ["dae", "spec"])
@pytest.mark.parametrize("name", sorted(R_ALL))
def test_workload_diagnostics_match_reference(name, variant):
    case, rcomp, tcomp = _both(name, variant)
    assert (_diags(verify.verify_function(function_from(case.fn)))
            == _diags(rverify.verify_function(case.fn)))
    got = verify.verify_compiled(tcomp, case.memory)
    assert _diags(got) == _diags(rverify.verify_compiled(rcomp, case.memory))
    assert not verify.soundness(got), [str(d) for d in got]
    diags, splits = differential(tcomp, case.memory)
    assert _diags(diags) == _diags(got)
    assert not splits, [str(d) for d in splits]


@pytest.mark.parametrize("name", sorted(R_ALL))
def test_mutants_match_reference(name):
    case, rcomp, tcomp = _both(name)
    for seed in (0, 1):
        want = [(k, rule, _diags(rverify.verify_compiled(m, case.memory)))
                for k, m, rule in rmutate.mutants(rcomp, seed)]
        got = [(k, rule, _diags(verify.verify_compiled(m, case.memory)))
               for k, m, rule in mutate.mutants(tcomp, seed)]
        assert got == want, f"{name}/seed{seed}"
        assert (mutate.check_mutants(tcomp, case.memory, seed)
                == rmutate.check_mutants(rcomp, case.memory, seed))
        for kind, rule, diags in got:
            assert any(d[0] == rule for d in diags), (name, kind, rule)


def test_steered_pair_and_its_mutants_match_reference():
    rpair = _steered_pair()  # the reference's IR
    tpair = _Pair(function_from(rpair.agu), function_from(rpair.cu))
    assert verify.verify_compiled(tpair) == []
    assert rverify.verify_compiled(rpair) == []
    got = mutate.check_mutants(tpair)
    assert got == rmutate.check_mutants(rpair)
    res = {kind: (rule, ok) for kind, rule, ok in got}
    for kind in ("drop-steer-reset", "drop-steer-set"):
        assert res[kind] == ("P03-steer-discipline", True), kind


@pytest.mark.parametrize("seed", range(8))
def test_negative_corpus_matches_reference(seed):
    g = rrandprog.generate(seed, negative=True)
    if g.mutate:
        rcomp = rpipeline.compile_spec(g.fn, g.decoupled)
        tcomp = pipeline.compile_spec(function_from(g.fn), g.decoupled)
        rm, tm = rmutate._clone(rcomp), mutate._clone(tcomp)
        assert rmutate._APPLY[g.mutate](rm, random.Random(seed))
        assert mutate._APPLY[g.mutate](tm, random.Random(seed))
        want = rverify.verify_compiled(rm, g.memory)
        got = verify.verify_compiled(tm, g.memory)
    else:
        want = rverify.verify_function(g.fn)
        got = verify.verify_function(function_from(g.fn))
        with pytest.raises(ValueError):
            pipeline.compile_spec(function_from(g.fn), g.decoupled)
    assert _diags(got) == _diags(want)
    assert any(d.rule == g.expect_rule for d in got), (seed, g.expect_rule)


def test_randprog_differential_clean():
    for kw in ({}, {"assoc_chains": True}):
        for seed in range(8):
            g = rrandprog.generate(seed, **kw)
            tcomp = pipeline.compile_spec(function_from(g.fn), g.decoupled)
            rcomp = rpipeline.compile_spec(g.fn, g.decoupled)
            diags, splits = differential(tcomp, g.memory)
            assert _diags(diags) == _diags(
                rverify.verify_compiled(rcomp, g.memory)), (seed, kw)
            assert not verify.soundness(diags) and not splits, (seed, kw)


def _cli(package):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", f"{package}.verify", "--all", "--mutants",
         "--randprog", "8", "--negative", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    # the last line ends with the run's wall time, which may differ
    text = re.sub(r" in [0-9.]+s$", "", out.stdout.rstrip(), flags=re.M)
    return out.returncode, text, out.stderr


def test_cli_subprocess_matches_reference():
    rc, text, err = _cli("repro_torch")
    assert rc == 0, text + err
    rrc, rtext, _ = _cli("repro")
    assert rrc == 0
    assert text == rtext
    assert text.splitlines()[-1] == "verify: 31 programs clean (0 findings)"


def test_analysis_modules_import_no_codegen():
    offenders = []
    for name in ("rules.py", "poisonflow.py", "decoupling.py", "mutate.py",
                 "__init__.py"):
        with open(os.path.join(SRC, name), encoding="utf-8") as fh:
            for ln, line in enumerate(fh, 1):
                code = line.split("#", 1)[0]
                if re.match(r"\s*(import|from)\s+[\w.]*\bcodegen\b", code):
                    offenders.append(f"{name}:{ln}: {line.strip()}")
    assert not offenders, offenders
    with open(os.path.join(SRC, "__main__.py"), encoding="utf-8") as fh:
        assert "from ..codegen import analysis" in fh.read()
    code = ("import sys\n"
            "import repro_torch.verify, repro_torch.verify.mutate\n"
            "bad = sorted(m for m in sys.modules if 'codegen' in m "
            "or m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_in_process_main_returns_zero(capsys):
    from repro_torch.verify.__main__ import main
    assert main(["--all", "--mutants"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("verify: 11 programs clean (0 findings)")
    assert sum(line.startswith("ok   workload/") for line in lines) == 11


def test_verify_error_and_registry_match_reference():
    assert verify.REGISTRY_VERSION == rverify.REGISTRY_VERSION
    assert verify.RULES == rverify.RULES
    assert verify.SCHEDULE_RULES == rverify.SCHEDULE_RULES
    d = verify.Diag("P02-request-unresolved", "cu:b", "wedged")
    err = verify.VerifyError([d])
    assert err.diags == [d]
    assert str(err) == str(rverify.VerifyError(
        [rverify.Diag("P02-request-unresolved", "cu:b", "wedged")]))
