"""The port's cycle simulator (repro_torch.core.machine, .core.sim) and
``run_all`` against the JAX package's, on the CPU.

The simulator is pure numpy in both packages, so the bar is bit for bit:

* **workloads** — every ``bench_irregular`` workload at its default size
  (the sizes ``benchmarks/dae_table1.py`` simulates) through
  ``repro_torch.core.pipeline.run_all`` and ``repro.core.pipeline.run_all``
  in each engine mode of ``tests/test_sim_equivalence.py`` (``MODES``):
  every field of each variant's result (cycles, store, load and poison
  counts, sync waits, LSQ high-water, the window counters, the store
  traces), the interpreter's trace, the final memory, and the compiled
  slices and poison statistics.  One run per workload and mode is shared
  by that leg's tests;
* **randprog** — an 8-seed sweep seeded from ``dae_test_seed()``;
* **deadlock** — a configuration with no FIFO room raises ``Deadlock``
  with the same diagnostic in both packages;
* **fallbacks and memos** — the interpreted slice process, and a
  compiled pair simulated after the codegen path ran it (the two memo
  families on ``Function`` must not collide).

Programs are carried across with :func:`repro_torch.core.ir.function_from`.
"""
import dataclasses

import numpy as np
import pytest

from conftest import dae_test_seed
from repro.bench_irregular import ALL as R_ALL
from repro.core import machine as rmachine
from repro.core import pipeline as rpipeline
from repro.core import randprog as rrandprog
from repro_torch import codegen
from repro_torch.core import machine, pipeline
from repro_torch.core.ir import function_from

#: (tag, batch_window, pipeline_window), as tests/test_sim_equivalence.py
MODES = (("evt", False, False),
         ("win", True, False),
         ("pipe", False, True),
         ("both", True, True))
VARIANTS = ("ref", "sta", "dae", "spec", "oracle")
_base = dae_test_seed()
RANDPROG_SEEDS = [(0 if _base == 0xDAE else _base) + i for i in range(8)]

_RUNS = {}


def _cfgs(mode, **kw):
    _, win, pipe = dict((m[0], m) for m in MODES)[mode]
    return (rmachine.MachineConfig(batch_window=win, pipeline_window=pipe,
                                   **kw),
            machine.MachineConfig(batch_window=win, pipeline_window=pipe,
                                  **kw))


def _pair(fn, decoupled, memory, params, mode, variants=VARIANTS):
    """Both packages' ``run_all`` on the same program and memory."""
    rcfg, tcfg = _cfgs(mode)
    r = rpipeline.run_all(fn, decoupled, memory, params=params, cfg=rcfg,
                          variants=variants)
    t = pipeline.run_all(function_from(fn), set(decoupled), memory,
                         params=params, cfg=tcfg, variants=variants)
    return r, t


def _bench(name, mode):
    key = (name, mode)
    if key not in _RUNS:
        case = R_ALL[name]()
        _RUNS[key] = _pair(case.fn, case.decoupled, case.memory,
                           case.params, mode)
    return _RUNS[key]


def _assert_same_variant(r, t, tag):
    assert r.name == t.name and r.cycles == t.cycles, tag
    assert set(r.memory) == set(t.memory), tag
    for k in r.memory:
        assert r.memory[k].dtype == t.memory[k].dtype, f"{tag}: dtype {k}"
        assert np.array_equal(r.memory[k], t.memory[k]), f"{tag}: {k}"
    if r.name == "ref":
        for f in ("stores", "loads", "blocks", "instr_count"):
            assert getattr(r.result, f) == getattr(t.result, f), \
                f"{tag}: trace {f}"
        return
    rr, tr = dataclasses.asdict(r.result), dataclasses.asdict(t.result)
    assert rr == tr, f"{tag}: {[f for f in rr if rr[f] != tr[f]]}"
    assert r.result.misspec_rate == t.result.misspec_rate, tag
    if r.name != "sta":
        rc, tc = r.compiled, t.compiled
        assert rc.agu.dump() == tc.agu.dump(), f"{tag}: agu slice"
        assert rc.cu.dump() == tc.cu.dump(), f"{tag}: cu slice"
        assert _stats(rc) == _stats(tc), f"{tag}: compile statistics"


def _stats(comp):
    ps, sp = comp.poison_stats, comp.spec
    return (None if ps is None else dataclasses.asdict(ps),
            None if sp is None else (sp.spec_requests, len(sp.fallback)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", [m[0] for m in MODES])
@pytest.mark.parametrize("bench", sorted(R_ALL))
def test_run_all_bit_identical(bench, mode, variant):
    r, t = _bench(bench, mode)
    assert set(r) == set(t) == set(VARIANTS)
    _assert_same_variant(r[variant], t[variant], f"{bench}/{mode}/{variant}")


@pytest.mark.parametrize("bench", sorted(R_ALL))
def test_table1_memories_agree(bench):
    """The port's own check, as ``benchmarks/dae_table1.py`` makes it:
    STA, DAE and SPEC end in the sequential interpreter's memory."""
    _, t = _bench(bench, "evt")
    for v in ("sta", "dae", "spec"):
        for k, want in t["ref"].memory.items():
            assert np.array_equal(t[v].memory[k], want), f"{bench}/{v}/{k}"


@pytest.mark.parametrize("seed", RANDPROG_SEEDS)
def test_randprog_bit_identical(seed):
    g = rrandprog.generate(seed, n_iter=24)
    for mode, _, _ in MODES:
        # oracle is wrong by design on random programs
        r, t = _pair(g.fn, g.decoupled, g.memory, None, mode,
                     variants=VARIANTS[:4])
        for v in VARIANTS[:4]:
            _assert_same_variant(r[v], t[v], f"seed{seed}/{mode}/{v}")


@pytest.mark.parametrize("bench,variant,cfg", [
    ("hist", "spec", dict(fifo_depth=0)),
    ("sssp", "dae", dict(stq=0)),
    ("pagerank", "spec", dict(ldq=0)),
])
def test_deadlock_raised_alike(bench, variant, cfg):
    case = R_ALL[bench]()
    rcomp = getattr(rpipeline, f"compile_{variant}")(case.fn, case.decoupled)
    tcomp = getattr(pipeline, f"compile_{variant}")(function_from(case.fn),
                                                    case.decoupled)
    for mode, _, _ in MODES:
        rcfg, tcfg = _cfgs(mode, **cfg)
        rmem = {k: v.copy() for k, v in case.memory.items()}
        tmem = {k: v.copy() for k, v in case.memory.items()}
        with pytest.raises(rmachine.Deadlock) as rexc:
            rmachine.run_dae(rcomp.agu, rcomp.cu, rmem, case.decoupled,
                             case.params, rcfg)
        with pytest.raises(machine.Deadlock) as texc:
            machine.run_dae(tcomp.agu, tcomp.cu, tmem, case.decoupled,
                            case.params, tcfg)
        assert str(rexc.value) == str(texc.value), f"{bench}/{mode}"
        for k in rmem:
            assert np.array_equal(rmem[k], tmem[k]), f"{bench}/{mode}/{k}"


def test_cycle_budget_deadlock_alike():
    case = R_ALL["hist"]()
    rcomp = rpipeline.compile_spec(case.fn, case.decoupled)
    tcomp = pipeline.compile_spec(function_from(case.fn), case.decoupled)
    for mode, _, _ in MODES:
        rcfg, tcfg = _cfgs(mode, max_cycles=3)
        with pytest.raises(rmachine.Deadlock) as rexc:
            rmachine.run_dae(rcomp.agu, rcomp.cu,
                             {k: v.copy() for k, v in case.memory.items()},
                             case.decoupled, case.params, rcfg)
        with pytest.raises(machine.Deadlock,
                           match="cycle budget exceeded") as texc:
            machine.run_dae(tcomp.agu, tcomp.cu,
                            {k: v.copy() for k, v in case.memory.items()},
                            case.decoupled, case.params, tcfg)
        assert str(rexc.value) == str(texc.value), mode


def test_interpreted_slice_process_bit_identical(monkeypatch):
    """Both packages with the slice compiler off: the interpreted
    generators, event-stepped and windowed, agree too."""
    from repro.core.sim import compile as rsimc
    from repro_torch.core.sim import compile as tsimc
    monkeypatch.setattr(rsimc, "compile_slice", lambda fn: None)
    monkeypatch.setattr(tsimc, "compile_slice", lambda fn: None)
    g = rrandprog.generate(7, n_iter=24)
    for mode in ("evt", "win"):
        r, t = _pair(g.fn, g.decoupled, g.memory, None, mode,
                     variants=("dae", "spec"))
        for v in ("dae", "spec"):
            _assert_same_variant(r[v], t[v], f"interp/{mode}/{v}")


def test_sim_and_codegen_memos_do_not_collide():
    """A compiled pair carries the simulator's memos (``_sim_*``) and the
    codegen path's (``_codegen_*``) side by side; running either first
    changes neither's result."""
    case = R_ALL["pagerank"]()
    fn = function_from(case.fn)
    comp = pipeline.compile_spec(fn, case.decoupled)
    cfg = machine.MachineConfig(batch_window=False, pipeline_window=False)

    def sim():
        mem = {k: v.copy() for k, v in case.memory.items()}
        r = machine.run_dae(comp.agu, comp.cu, mem, case.decoupled,
                            case.params, cfg)
        return dataclasses.asdict(r), mem

    def gen():
        mem = {k: v.copy() for k, v in case.memory.items()}
        r = codegen.run(comp, mem, case.params, target="torch",
                        device="cpu")
        return r.stats, mem

    first = sim()
    g1 = gen()
    assert {a for a in vars(comp.cu) if a.startswith("_sim_")}
    assert {a for a in vars(comp.cu) if a.startswith("_codegen_")}
    again, g2 = sim(), gen()
    assert first[0] == again[0] and g1[0] == g2[0]
    for k in first[1]:
        assert np.array_equal(first[1][k], again[1][k])
        assert np.array_equal(first[1][k], g1[1][k])
        assert np.array_equal(g1[1][k], g2[1][k])


def test_config_defaults_and_env_knobs(monkeypatch):
    for name in ("DAE_SIM_WINDOW", "DAE_SIM_PIPELINE"):
        monkeypatch.delenv(name, raising=False)
    assert (dataclasses.asdict(machine.MachineConfig())
            == dataclasses.asdict(rmachine.MachineConfig()))
    monkeypatch.setenv("DAE_SIM_WINDOW", "1")
    monkeypatch.setenv("DAE_SIM_PIPELINE", "yes")
    cfg = machine.MachineConfig()
    assert cfg.batch_window and cfg.pipeline_window
    assert (dataclasses.asdict(cfg)
            == dataclasses.asdict(rmachine.MachineConfig()))
