"""The port's compile cache (repro_torch.frontend.cache) and the
``cache=`` / ``verify=`` arguments of ``Program.compile`` against the JAX
package's, on the CPU.

* **counters** — the same script of compiles (cold, warm, invalidate,
  corrupt payload, IR drift, schema bump, verdict-registry drift) on
  pagerank and join gives the reference's ``cache_stats`` outcome and
  hit / miss / stale / invalidated counters at every step;
* **warm runs** — a warm object runs through ``repro_torch.codegen.run``
  on CPU tensors bitwise equal to the interpreter, with no re-analysis
  and no re-emission, and its cache provenance reaches the run record;
* **verify** — warm hits replay the stored verdict, a planted dirty
  verdict raises, ``build(verify=True)`` runs the source pass;
* **shared directory** — in one ``DAE_CACHE_DIR`` the reference's entry is
  never the port's: the port compiles cold after the reference, and a
  reference payload planted under the port's key is stale, refused by
  the port's unpickler before ``repro`` is imported.
"""
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro_torch.verify as verify_mod
from repro.bench_irregular import join as rjoin
from repro.bench_irregular import pagerank as rpagerank
from repro.frontend import CompileCache as RCompileCache
from repro.frontend import cache as rcache_mod
from repro_torch import codegen
from repro_torch.bench_irregular import ALL, join, pagerank
from repro_torch.core import interp
from repro_torch.frontend import CompileCache, cache as cache_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {"pagerank": (pagerank.program, rpagerank.program),
            "join": (join.program, rjoin.program)}


def _state(cc, comp):
    return (comp.cache_stats["outcome"], cc.hits, cc.misses, cc.stale,
            cc.invalidated)


def _only_entry(root):
    [name] = [n for n in os.listdir(root) if n.endswith(".pkl")]
    return os.path.join(root, name)


def _edit_payload(path, edit):
    """Rewrite a payload in place; ``pickle.load`` of this package's own
    entry only (the test made it)."""
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    edit(payload)
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)


def _script(factory, cc, mod):
    """One fixed script of compiles; the (outcome, counters) after each."""
    case = ALL[factory.__module__.rsplit(".", 1)[1]]()
    dec = set(case.decoupled)
    seen = []

    def step(**kw):
        comp = factory().compile(dec, cache=cc, **kw)
        seen.append(_state(cc, comp))
        return comp

    step()                                   # cold
    step()                                   # warm
    assert cc.invalidate(factory(), dec)
    step()                                   # cold again
    step(mode="dae")                         # another key
    os.unlink(cc._path(cc.key(factory().signature(), dec, "dae")))
    path = cc._path(cc.key(factory().signature(), dec, "spec"))
    with open(path, "wb") as fh:             # corrupt payload
        fh.write(b"not a pickle")
    step()                                   # stale, rewritten
    step()                                   # warm
    _edit_payload(path, lambda p: p.update(dump=p["dump"] + "\n; drift"))
    step()                                   # stale: IR drift
    step(verify=True)                        # warm, verdict replayed
    _edit_payload(path, lambda p: p["verdict"].update(registry=0))
    step(verify=True)                        # stale: registry drift
    step()                                   # warm
    old = mod.SCHEMA
    mod.SCHEMA = old + 1
    try:
        step()                               # cold: new schema, new key
    finally:
        mod.SCHEMA = old
    seen.append(("clear", cc.clear()))
    step()                                   # cold after clear
    return seen


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_counters_match_reference(family, tmp_path):
    tfac, rfac = FAMILIES[family]
    got = _script(tfac, CompileCache(str(tmp_path / "port")), cache_mod)
    want = _script(rfac, RCompileCache(str(tmp_path / "ref")), rcache_mod)
    assert got == want
    assert [s[0] for s in got] == [
        "cold", "warm", "cold", "cold", "stale", "warm", "stale", "warm",
        "stale", "warm", "cold", "clear", "cold"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_warm_object_runs_bitwise_without_reanalysis(family, tmp_path,
                                                     monkeypatch):
    factory = FAMILIES[family][0]
    case = ALL[family]()
    cc = CompileCache(str(tmp_path))
    cold = factory().compile(case.decoupled, cache=cc, verify=True)
    assert cold.cache_stats["outcome"] == "cold"

    def boom(*a, **k):
        raise AssertionError("warm cache path re-analyzed or re-emitted")
    monkeypatch.setattr(codegen, "_analyze_slices", boom)
    monkeypatch.setattr(codegen.emit, "emit_source", boom)
    monkeypatch.setattr(codegen.analysis, "analyze", boom)
    monkeypatch.setattr(codegen.analysis, "uniform_loops", boom)
    monkeypatch.setattr(verify_mod, "verify_compiled", boom)
    warm = factory().compile(case.decoupled, cache=cc, verify=True)
    assert warm.cache_stats["outcome"] == "warm"
    assert warm._verify_verdict == cold._verify_verdict

    ref = {k: v.copy() for k, v in case.memory.items()}
    interp.run(case.fn, ref, case.params)
    for cu_mode in ("state-machine", "vector"):
        mem = {k: v.copy() for k, v in case.memory.items()}
        r = codegen.run(warm, mem, case.params, target="torch",
                        device="cpu", cu_mode=cu_mode)
        assert r.target_used == "torch" and r.cu_mode == cu_mode
        assert r.cache["outcome"] == "warm" and r.cache["hits"] == 1
        for k in ref:
            assert mem[k].dtype == ref[k].dtype
            assert np.array_equal(mem[k], ref[k]), (cu_mode, k)


def test_payload_holds_no_tensor_or_runner(tmp_path):
    """What is pickled is device-free: no tensor, no staging ring, no
    compiled runner; runners come back from the source texts."""
    cc = CompileCache(str(tmp_path))
    case = ALL["join"]()
    comp = join.program().compile(case.decoupled, cache=cc)
    mem = {k: v.copy() for k, v in case.memory.items()}
    codegen.run(comp, mem, case.params, target="torch", device="cpu")
    classes = []

    class Recorder(cache_mod._PortUnpickler):
        def find_class(self, module, name):
            classes.append((module, name))
            return super().find_class(module, name)

    with open(_only_entry(str(tmp_path)), "rb") as fh:
        payload = Recorder(fh).load()
    mods = {m for m, _ in classes}
    assert {m.split(".")[0] for m in mods} <= {"repro_torch", "builtins",
                                               "numpy"}
    assert not [m for m in mods if m.startswith(("repro_torch.kernels",
                                                 "repro_torch.codegen"))
                and not m.startswith("repro_torch.codegen.analysis")], mods
    assert set(payload["sources"]) == set(codegen.emit.MODES)


def test_stale_verdict_recompiles_and_dirty_verdict_raises(tmp_path):
    cc = CompileCache(str(tmp_path))
    dec = ALL["join"]().decoupled
    join.program().compile(dec, cache=cc, verify=True)
    path = _only_entry(str(tmp_path))
    _edit_payload(path, lambda p: p["verdict"].update(registry=0))
    c = join.program().compile(dec, cache=cc, verify=True)
    assert c.cache_stats["outcome"] == "stale"
    evs = [e for e in cc.events if e.site == "frontend.cache_stale"]
    assert evs and "registry" in evs[-1].cause
    assert c._verify_verdict["registry"] == verify_mod.REGISTRY_VERSION
    _edit_payload(path, lambda p: p["verdict"].update(diags=[
        ("P02-request-unresolved", "cu:latch", "planted for the test")]))
    with pytest.raises(verify_mod.VerifyError, match="P02"):
        join.program().compile(dec, cache=cc, verify=True)


def test_uncached_verify_and_build_verify():
    dec = ALL["pagerank"]().decoupled
    comp = pagerank.program().compile(dec, cache=False, verify=True)
    assert comp.cache_stats is None
    pagerank.program().build(verify=True)


def test_resolve_cache_env(tmp_path, monkeypatch):
    monkeypatch.delenv("DAE_CACHE_DIR", raising=False)
    assert cache_mod.resolve_cache(None) is None
    assert cache_mod.resolve_cache(False) is None
    with pytest.raises(TypeError):
        cache_mod.resolve_cache("a path")
    monkeypatch.setenv("DAE_CACHE_DIR", str(tmp_path))
    cc = cache_mod.resolve_cache(None)
    assert isinstance(cc, CompileCache)
    assert cache_mod.resolve_cache(None) is cc
    comp = join.program().compile(ALL["join"]().decoupled)
    assert comp.cache_stats["outcome"] == "cold"
    assert os.listdir(tmp_path)


def test_keys_differ_from_reference(tmp_path):
    dec = ALL["join"]().decoupled
    sig = join.program().signature()
    assert sig == rjoin.program().signature()
    port = CompileCache(str(tmp_path)).key(sig, dec, "spec")
    ref = RCompileCache(str(tmp_path)).key(sig, dec, "spec")
    assert port != ref


def _run(code, cache_dir):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               DAE_CACHE_DIR=str(cache_dir))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout.strip().splitlines()[-1]


_PORT = """
    import sys
    from repro_torch.bench_irregular import ALL, {family}
    comp = {family}.program().compile(ALL["{family}"]().decoupled)
    st = comp.cache_stats
    bad = sorted(m for m in sys.modules if m.split(".")[0] == "repro")
    print(st["outcome"], st["hits"], st["misses"], st["stale"], bad)
"""
_REF = """
    from repro.bench_irregular import ALL, {family}
    comp = {family}.program().compile(ALL["{family}"]().decoupled)
    print(comp.cache_stats["outcome"], comp.cache_stats["key"])
"""


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shared_cache_dir_never_serves_the_reference(family, tmp_path):
    ref_out = _run(_REF.format(family=family), tmp_path)
    outcome, ref_key = ref_out.split()
    assert outcome == "cold"
    # the reference's entry is there, under its own key: the port misses
    assert _run(_PORT.format(family=family), tmp_path) == "cold 0 1 0 []"
    assert _run(_PORT.format(family=family), tmp_path) == "warm 1 0 0 []"
    # plant the reference's payload under the port's key: the port's
    # unpickler refuses it (stale) before anything of repro is imported
    sig = FAMILIES[family][0]().signature()
    port_path = CompileCache(str(tmp_path))._path(CompileCache(
        str(tmp_path)).key(sig, ALL[family]().decoupled, "spec"))
    shutil.copyfile(os.path.join(str(tmp_path), f"{ref_key}.pkl"), port_path)
    assert _run(_PORT.format(family=family), tmp_path) == "stale 0 0 1 []"
    assert _run(_PORT.format(family=family), tmp_path) == "warm 1 0 0 []"
    assert os.path.exists(os.path.join(str(tmp_path), f"{ref_key}.pkl"))


def test_unpickler_refuses_foreign_classes(tmp_path):
    cc = CompileCache(str(tmp_path))
    dec = ALL["join"]().decoupled
    join.program().compile(dec, cache=cc)
    path = _only_entry(str(tmp_path))
    _edit_payload(path, lambda p: p.update(extra=os.path.join))
    c = join.program().compile(dec, cache=cc)
    assert c.cache_stats["outcome"] == "stale"
    assert "outside" in c.cache_stats["events"][-1].cause
