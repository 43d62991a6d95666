"""The port's codegen path (repro_torch.codegen) against the JAX reference.

Same seeded inputs through ``repro_torch.codegen.run(target="torch",
device="cpu")`` — the kernels' plain versions — and
``repro.codegen.run(target="jax", interpret=True)``:

* **parity matrix** — every workload at ``tests/test_codegen.py``'s
  ``SMALL`` sizes x {dae, spec} x {vector, state-machine}: final memory
  bitwise equal to the reference run and to both interpreters, the
  ``CodegenRun`` fields and counters equal (``target_used`` reads
  ``"torch"`` where the reference reads ``"jax"``).  The matrix is split
  by workload between this file and ``test_torch_codegen_parity.py``
  so the two halves run on different workers; one reference run per leg
  is shared by the leg's tests through a module-scoped cache;
* **reference checks** — the seeded randprog sweep carried across by
  :func:`repro_torch.core.ir.function_from`, the forwarding stress
  matrix, the int32 and dtype refusals, an armed fault leg that
  descends the ladder like the reference, the emitted sources;
* **boundaries** — the port imports neither jax nor ``repro``, and the
  torch target never carries on on the CPU unasked.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import dae_test_seed
from repro import codegen as rcodegen
from repro.bench_irregular import ALL as R_ALL
from repro.core import interp as rinterp
from repro.core import pipeline as rpipeline
from repro.core import randprog as rrandprog
from repro.resilience import faults as rfaults
from repro_torch import codegen
from repro_torch.bench_irregular import ALL
from repro_torch.core import interp, pipeline, randprog
from repro_torch.core.ir import Function, LoopNest, function_from
from repro_torch.resilience import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: tests/test_codegen.py's reduced sizes for the interpret-mode jax legs
SMALL = {
    "bfs": dict(n_nodes=24, n_edges=64),
    "bc": dict(n_nodes=20, n_edges=48),
    "sssp": dict(n_nodes=20, n_edges=56),
    "hist": dict(n=96),
    "thr": {},
    "mm": {},
    "fw": dict(n=6),
    "sort": dict(n=16),
    "spmv": dict(n=12),
    "pagerank": dict(n=12, n_edges=32, iters=2),
    "join": dict(n_r=12, n_s=16, n_buckets=24),
}
#: the half of the parity matrix this file runs (the rest:
#: test_torch_codegen_parity.py)
WORKLOADS = ("pagerank", "sort", "spmv", "sssp", "thr")
RUN_FIELDS = ("cu_mode", "vector_reason", "forward_reason")
STAT_KEYS = ("epochs", "gather_calls", "scatter_calls", "ld_leftover",
             "st_leftover", "stores_committed", "stores_poisoned",
             "loads_consumed", "fwd_epochs", "fwd_refusals")
LEGS = [(w, p, m) for w in WORKLOADS for p in ("dae", "spec")
        for m in ("vector", "state-machine")]


def _copy(mem):
    return {k: v.copy() for k, v in mem.items()}


def _assert_exact(ref, mem, tag):
    assert set(ref) == set(mem), tag
    for k in ref:
        assert ref[k].dtype == mem[k].dtype, f"{tag}: dtype of {k}"
        assert np.array_equal(ref[k], mem[k]), f"{tag}: array {k} differs"


def _used(target_used):
    return "torch" if target_used == "jax" else target_used


def run_leg(name, pname, cu_mode, **kw):
    """One parity leg: the reference jax run, the port's torch run on the
    CPU, and both interpreters, from the same seeded build."""
    rcase, tcase = R_ALL[name](**kw), ALL[name](**kw)
    assert rcase.fn.dump() == tcase.fn.dump()
    _assert_exact(rcase.memory, tcase.memory, f"{name}: inputs")
    rcomp = getattr(rpipeline, f"compile_{pname}")(rcase.fn, rcase.decoupled)
    tcomp = getattr(pipeline, f"compile_{pname}")(tcase.fn, tcase.decoupled)
    rmem, tmem = _copy(rcase.memory), _copy(tcase.memory)
    rrun = rcodegen.run(rcomp, rmem, rcase.params, target="jax",
                        interpret=True, cu_mode=cu_mode)
    trun = codegen.run(tcomp, tmem, tcase.params, target="torch",
                       device="cpu", cu_mode=cu_mode)
    rint, tint = _copy(rcase.memory), _copy(tcase.memory)
    rinterp.run(rcase.fn, rint, rcase.params)
    interp.run(tcase.fn, tint, tcase.params)
    return {"ref": (rrun, rmem), "port": (trun, tmem),
            "interp": (rint, tint)}


@pytest.fixture(scope="module")
def legs():
    cache = {}

    def get(name, pname, cu_mode):
        key = (name, pname, cu_mode)
        if key not in cache:
            cache[key] = run_leg(name, pname, cu_mode, **SMALL[name])
        return cache[key]
    return get


def check_memory(leg, tag):
    _, rmem = leg["ref"]
    _, tmem = leg["port"]
    rint, tint = leg["interp"]
    _assert_exact(rint, tint, f"{tag}: interpreters")
    _assert_exact(rmem, tmem, f"{tag}: port vs reference")
    _assert_exact(tint, tmem, f"{tag}: port vs interpreter")


def check_fields(leg, pname, cu_mode, tag):
    rrun, _ = leg["ref"]
    trun, _ = leg["port"]
    assert trun.target == "torch"
    assert trun.target_used == _used(rrun.target_used), tag
    for f in RUN_FIELDS:
        assert getattr(trun, f) == getattr(rrun, f), f"{tag}: {f}"
    assert (trun.fallback_reason is None) == (rrun.fallback_reason is None)
    assert [(e.site, e.rung, e.retries, e.outcome) for e in trun.events] \
        == [(e.site, e.rung, e.retries, e.outcome) for e in rrun.events]
    if pname == "spec":
        # every SPEC CU is iteration-uniform: the pinned mode must run
        assert trun.target_used == "torch" and trun.cu_mode == cu_mode
    else:
        assert trun.fell_back and "value-dependent" in trun.fallback_reason


def check_stats(leg, pname, tag):
    rrun, _ = leg["ref"]
    trun, _ = leg["port"]
    for k in STAT_KEYS:
        assert trun.stats.get(k) == rrun.stats.get(k), f"{tag}: {k}"
    if pname == "spec":
        assert trun.stats["gather_calls"] > 0
        assert trun.stats["scatter_calls"] > 0


@pytest.mark.parametrize("name,pname,cu_mode", LEGS)
def test_parity_memory(legs, name, pname, cu_mode):
    check_memory(legs(name, pname, cu_mode), f"{name}/{pname}/{cu_mode}")


@pytest.mark.parametrize("name,pname,cu_mode", LEGS)
def test_parity_run_fields(legs, name, pname, cu_mode):
    check_fields(legs(name, pname, cu_mode), pname, cu_mode,
                 f"{name}/{pname}/{cu_mode}")


@pytest.mark.parametrize("name,pname,cu_mode", LEGS)
def test_parity_stats(legs, name, pname, cu_mode):
    check_stats(legs(name, pname, cu_mode), pname,
                f"{name}/{pname}/{cu_mode}")


@pytest.mark.parametrize("pname", ["dae", "spec"])
@pytest.mark.parametrize("name", sorted(ALL))
def test_emitted_sources_match_reference(name, pname):
    """Same slices, same emitted text on every lowering (the torch
    target keeps the reference's ``cu-jax`` emission mode)."""
    rcase, tcase = R_ALL[name](), ALL[name]()
    rcomp = getattr(rpipeline, f"compile_{pname}")(rcase.fn, rcase.decoupled)
    tcomp = getattr(pipeline, f"compile_{pname}")(tcase.fn, tcase.decoupled)
    assert tcomp.agu.dump() == rcomp.agu.dump()
    assert tcomp.cu.dump() == rcomp.cu.dump()
    assert codegen.lower(tcomp, "torch") == rcodegen.lower(rcomp, "jax")
    assert codegen.lower(tcomp, "numpy") == rcodegen.lower(rcomp, "numpy")


# ---------------------------------------------------------------------------
# randprog carried across by function_from
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("assoc", [False, True])
@pytest.mark.parametrize("k", range(16))
def test_randprog_carried_across_matches_reference(k, assoc):
    seed = (dae_test_seed() + k) % (2 ** 31)
    g = rrandprog.generate(seed, assoc_chains=assoc)
    fn = function_from(g.fn)
    assert fn.dump() == g.fn.dump()
    # the port's own generator is the same program
    assert randprog.generate(seed, assoc_chains=assoc).fn.dump() == fn.dump()
    ref = _copy(g.memory)
    rinterp.run(g.fn, ref)
    for pname in ("dae", "spec"):
        rcomp = getattr(rpipeline, f"compile_{pname}")(g.fn, g.decoupled)
        tcomp = getattr(pipeline, f"compile_{pname}")(fn, set(g.decoupled))
        assert tcomp.cu.dump() == rcomp.cu.dump()
        rmem, tmem = _copy(g.memory), _copy(g.memory)
        rrun = rcodegen.run(rcomp, rmem, target="jax", interpret=True)
        trun = codegen.run(tcomp, tmem, target="torch", device="cpu")
        tag = f"randprog{seed}/{pname}/assoc={assoc}"
        _assert_exact(ref, tmem, tag)
        _assert_exact(rmem, tmem, tag)
        assert trun.target_used == _used(rrun.target_used), tag
        assert trun.cu_mode == rrun.cu_mode, tag
        for key in STAT_KEYS:
            assert trun.stats.get(key) == rrun.stats.get(key), (tag, key)


def test_function_from_copies_without_sharing():
    f = Function("carry")
    f.array("A", 4)
    nest = LoopNest(f)
    b = nest.enter("i", nest.const(4, "N"))
    b.load("av", "A", "i", tagged=[1])
    b.store("A", "i", "av")
    b.br(nest.latch)
    nest.finish()
    g = function_from(f)
    assert g is not f and g.dump() == f.dump() and g._uid == f._uid
    g.blocks["body"].body[0].meta["tagged"].append(2)
    g.blocks["body"].body.pop()
    assert f.blocks["body"].body[0].meta["tagged"] == [1]
    assert len(f.blocks["body"].body) == 2


# ---------------------------------------------------------------------------
# forwarding stress, refusals, faults
# ---------------------------------------------------------------------------


def _stress_cases(all_):
    """tests/test_codegen.py's same-address stress workloads."""
    hist1 = all_["hist"](n=96, n_bins=8)
    hist1.memory["bins"][:] = 0
    hist_sat = all_["hist"](n=96, n_bins=4, max_count=8)
    hist_sat.memory["bins"][:] = 0
    dense = all_["spmv"](n=12, density=1.0, x_zero_rate=0.0)
    dense.memory["row"][:] = 0
    coll = all_["sort"](n=16)
    coll.memory["a"][:] = coll.memory["a"] % 2
    return {"hist-onebin": hist1, "hist-saturate": hist_sat,
            "spmv-dense-row": dense, "sort-collide": coll}


@pytest.mark.parametrize("cu_mode", ["state-machine", "vector"])
@pytest.mark.parametrize("sname", ["hist-onebin", "hist-saturate",
                                   "spmv-dense-row", "sort-collide"])
def test_forwarding_stress_matrix_matches_reference(sname, cu_mode):
    rcase, tcase = _stress_cases(R_ALL)[sname], _stress_cases(ALL)[sname]
    rcomp = rpipeline.compile_spec(rcase.fn, rcase.decoupled)
    tcomp = pipeline.compile_spec(tcase.fn, tcase.decoupled)
    ref = _copy(tcase.memory)
    interp.run(tcase.fn, ref, tcase.params)
    rmem, tmem = _copy(rcase.memory), _copy(tcase.memory)
    rrun = rcodegen.run(rcomp, rmem, rcase.params, target="jax",
                        interpret=True, cu_mode=cu_mode)
    trun = codegen.run(tcomp, tmem, tcase.params, target="torch",
                       device="cpu", cu_mode=cu_mode)
    _assert_exact(ref, tmem, f"{sname}/{cu_mode}")
    _assert_exact(rmem, tmem, f"{sname}/{cu_mode}")
    assert trun.target_used == "torch" and trun.cu_mode == cu_mode
    assert trun.forward_reason == rrun.forward_reason
    for key in STAT_KEYS:
        assert trun.stats.get(key) == rrun.stats.get(key), key
    if cu_mode == "vector" and sname != "sort-collide":
        assert trun.stats["fwd_epochs"] > 0 and trun.stats["epochs"] <= 2


def test_int32_range_violation_mid_run_falls_back_clean():
    """A store value outside int32 is only seen at flush time, after the
    CU's local-array writes are pending: the refused torch run must leave
    memory pristine so the coupled rung still ends exact."""
    f = Function("bigval")
    f.array("A", 4)
    f.array("L", 1)
    nest = LoopNest(f)
    b = nest.enter("i", nest.const(4, "N"))
    b.load("lv", "L", "zero")
    b.bin("l1", "+", "lv", "one")
    b.store("L", "zero", "l1")
    b.load("av", "A", "i")
    b.bin("v", "+", "av", nest.const(1 << 40, "BIG"))
    b.store("A", "i", "v")
    b.br(nest.latch)
    nest.finish()
    mem0 = {"A": np.arange(4, dtype=np.int64), "L": np.zeros(1, np.int64)}
    ref = _copy(mem0)
    interp.run(f, ref)
    for pname in ("dae", "spec"):
        comp = getattr(pipeline, f"compile_{pname}")(f, {"A"})
        for cu_mode in ("auto", "state-machine"):
            mem = _copy(mem0)
            r = codegen.run(comp, mem, target="torch", device="cpu",
                            cu_mode=cu_mode)
            _assert_exact(ref, mem, f"bigval/{pname}/{cu_mode}")
            assert r.fell_back and "int32" in r.fallback_reason


def test_non_integer_array_falls_back():
    f = Function("fprog")
    f.array("A", 8)
    f.array("idx", 8)
    nest = LoopNest(f)
    b = nest.enter("i", nest.const(8, "N"))
    b.load("j", "idx", "i")
    b.load("av", "A", "j")
    b.bin("v", "+", "av", "one")
    b.store("A", "i", "v")
    b.br(nest.latch)
    nest.finish()
    rng = np.random.default_rng(7)
    mem0 = {"A": rng.random(8).astype(np.float64),
            "idx": rng.integers(0, 8, 8).astype(np.int64)}
    ref = _copy(mem0)
    interp.run(f, ref)
    comp = pipeline.compile_spec(f, {"A"})
    mem = _copy(mem0)
    r = codegen.run(comp, mem, target="torch", device="cpu")
    _assert_exact(ref, mem, "float/torch")
    assert r.fell_back and "non-integer" in r.fallback_reason
    mem = _copy(mem0)
    assert codegen.run(comp, mem, target="numpy").target_used == "numpy"
    _assert_exact(ref, mem, "float/numpy")


@pytest.mark.parametrize("cu_mode", ["vector", "state-machine"])
def test_armed_gather_rows_descends_like_reference(cu_mode):
    """kernels.gather.rows corrupts every gather: both packages detect it
    against their replicas, retry, descend rung by rung through the same
    events, and end bit-identical on the coupled interpreter."""
    kw = SMALL["hist"]
    rcase, tcase = R_ALL["hist"](**kw), ALL["hist"](**kw)
    rcomp = rpipeline.compile_spec(rcase.fn, rcase.decoupled)
    tcomp = pipeline.compile_spec(tcase.fn, tcase.decoupled)
    ref = _copy(tcase.memory)
    interp.run(tcase.fn, ref, tcase.params)
    rmem, tmem = _copy(rcase.memory), _copy(tcase.memory)
    with rfaults.armed(rfaults.FaultPlan({"kernels.gather.rows": 1.0},
                                         seed=3)):
        rrun = rcodegen.run(rcomp, rmem, rcase.params, target="jax",
                            interpret=True, cu_mode=cu_mode)
    with faults.armed(faults.FaultPlan({"kernels.gather.rows": 1.0},
                                       seed=3)) as plan:
        trun = codegen.run(tcomp, tmem, tcase.params, target="torch",
                           device="cpu", cu_mode=cu_mode)
    assert not faults.ACTIVE and not rfaults.ACTIVE
    assert plan.fired
    _assert_exact(ref, tmem, f"armed/{cu_mode}")
    _assert_exact(rmem, tmem, f"armed/{cu_mode}")
    assert trun.fell_back and rrun.fell_back
    tev = [(e.site, e.rung, e.retries, e.outcome, e.cause)
           for e in trun.events]
    rev = [(e.site, e.rung, e.retries, e.outcome, e.cause)
           for e in rrun.events]
    assert tev == rev and any(e[3] == "descend" for e in tev)


# ---------------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------------


def test_import_boundary_no_jax_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.codegen, repro_torch.bench_irregular, "
        "repro_torch.kernels\n"
        "import repro_torch.kernels.spec_gather, "
        "repro_torch.kernels.spec_scatter, repro_torch.frontend\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.configs, repro_torch.models.model, "
        "repro_torch.models.convert\n"
        "import repro_torch.serve.engine, repro_torch.serve.traffic, "
        "repro_torch.launch.serve\n"
        "import repro_torch.core.machine, repro_torch.core.sim, "
        "repro_torch.verify, repro_torch.verify.__main__, "
        "repro_torch.frontend.cache\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_source_scan_no_jax_no_repro_import():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|repro\b"
                     r"(?!_torch))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path, encoding="utf-8") as fh:
            m = pat.search(fh.read())
        assert m is None, f"{path}: {m.group(0).strip()}"


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = ALL["hist"](**SMALL["hist"])
    comp = pipeline.compile_spec(case.fn, case.decoupled)
    mem = _copy(case.memory)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            codegen.run(comp, mem, case.params, target="torch",
                        device=device)
    # the default target is the card, so a bare call raises too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codegen.run(comp, mem, case.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comp.run_generated(mem, case.params)
    _assert_exact(case.memory, mem, "untouched")
    with pytest.raises(ValueError):
        codegen.run(comp, mem, case.params, target="numpy", device="cpu")
    with pytest.raises(ValueError):
        codegen.run(comp, mem, case.params, target="jax")

