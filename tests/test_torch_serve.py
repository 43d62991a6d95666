"""The port's serving engine and traffic harness (repro_torch.serve)
against the JAX reference, on the CPU.

On the reference's own parameters (``params_from_numpy``) and the same
requests, the port's ``Engine.run`` commits the reference's greedy tokens
bit for bit, with equal per-wave token, request and poison counts, for
the Kimi-K2 (moe, ``spec``, ``spec-kernel`` and ``dense`` dispatch) and
Granite-34B (dense family) smoke configs, float32.  The rest mirrors the flat, mesh-free
serving legs of ``tests/test_moe_serve.py`` on the port alone: batching
invariance, explicit truncation, wave-stats accounting, the traffic
report, and the three chaos legs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro.serve.traffic import TrafficConfig as RTrafficConfig
from repro.serve.traffic import make_requests as rmake_requests
from repro.serve.traffic import run_traffic as rrun_traffic
from repro_torch.configs import base
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.resilience import faults
from repro_torch.resilience.faults import FaultPlan
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.traffic import (TrafficConfig, make_requests,
                                       run_traffic)

CFG = base.smoke(base.get("kimi_k2_1t_a32b"))        # moe family
DENSE_CFG = base.smoke(base.get("granite_34b"))      # dense family


def _prompts(lens, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lens]


def _engine(cfg, **kw):
    return Engine(cfg, device="cpu", **kw)


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

LEGS = [("kimi_k2_1t_a32b", "spec-kernel"), ("kimi_k2_1t_a32b", "spec"),
        ("kimi_k2_1t_a32b", "dense"), ("granite_34b", "spec")]


def _stats(waves):
    return [(w.batch, w.tokens, w.moe_poison, w.moe_requests, w.truncated)
            for w in waves]


@pytest.fixture(scope="module", params=LEGS, ids=lambda p: "-".join(p))
def engine_reference(request):
    """One reference run: five ragged requests over two waves of three
    slots, one of them truncated at max_len; low capacity for the moe
    family so the capacity race poisons requests."""
    arch, dispatch = request.param
    cfg = rbase.smoke(rbase.get(arch))
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    eng = REngine(cfg, slots=3, max_len=20, dispatch=dispatch)
    prompts = _prompts([4, 7, 5, 9, 13], cfg.vocab, seed=4)
    max_new = [5, 3, 6, 4, 9]
    reqs = [RRequest(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    res = eng.run(reqs)
    return dict(cfg=cfg, dispatch=dispatch, prompts=prompts, max_new=max_new,
                params=jax.tree.map(np.asarray, eng.params), results=res,
                stats=_stats(eng.wave_stats),
                truncated=[r.truncated for r in reqs],
                events=[(e.site, e.outcome) for e in eng.events])


def test_engine_tokens_match_reference(engine_reference):
    r = engine_reference
    cfg = base.smoke(base.get(r["cfg"].name))
    cfg = dataclasses.replace(cfg, capacity_factor=r["cfg"].capacity_factor)
    eng = _engine(cfg, params=params_from_numpy(r["params"]), slots=3,
                  max_len=20, dispatch=r["dispatch"])
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(r["prompts"], r["max_new"]))]
    assert eng.run(reqs) == r["results"]
    assert _stats(eng.wave_stats) == r["stats"]
    assert [q.truncated for q in reqs] == r["truncated"]
    assert [(e.site, e.outcome) for e in eng.events] == r["events"]
    assert any(r["truncated"])
    if cfg.family == "moe" and r["dispatch"] != "dense":
        assert sum(s[2] for s in r["stats"]) > 0, "no capacity race"


def test_traffic_matches_reference():
    """The same trace through both harnesses: the same tokens, poison and
    request counts (latencies are wall-clock and differ)."""
    rcfg = rbase.smoke(rbase.get("kimi_k2_1t_a32b"))
    reng = REngine(rcfg, slots=4, max_len=32, dispatch="spec-kernel")
    kw = dict(n_requests=6, rate=500.0, prompt_len=(4, 6), max_new=(2, 3),
              seed=3)
    want = rrun_traffic(reng, RTrafficConfig(**kw))
    eng = _engine(CFG, params=params_from_numpy(
        jax.tree.map(np.asarray, reng.params)), slots=4, max_len=32,
        dispatch="spec-kernel")
    got = run_traffic(eng, TrafficConfig(**kw))
    for k in ("tokens", "moe_poison", "moe_requests", "n_completed",
              "n_failed", "n_truncated"):
        assert getattr(got, k) == getattr(want, k), k
    assert _stats(got.waves) == _stats(want.waves)
    reqs, arr = make_requests(TrafficConfig(**kw), CFG.vocab)
    rreqs, rarr = rmake_requests(RTrafficConfig(**kw), CFG.vocab)
    np.testing.assert_array_equal(arr, rarr)
    assert [(r.prompt.tolist(), r.max_new) for r in reqs] == \
        [(r.prompt.tolist(), r.max_new) for r in rreqs]


# ---------------------------------------------------------------------------
# serving semantics (the port alone)
# ---------------------------------------------------------------------------


def test_batching_invariance():
    """A batched left-padded wave emits exactly the tokens each request
    gets served solo: pads are poisoned, not token 0."""
    eng = _engine(DENSE_CFG, slots=4, max_len=32)
    prompts = _prompts([3, 5, 7, 4], DENSE_CFG.vocab)
    batched = eng.run([Request(rid=i, prompt=p, max_new=4)
                       for i, p in enumerate(prompts)])
    solo_eng = _engine(DENSE_CFG, params=eng.params, slots=1, max_len=32)
    for i, p in enumerate(prompts):
        solo = solo_eng.run([Request(rid=0, prompt=p, max_new=4)])
        assert batched[i] == solo[0], (
            f"request {i} (len {len(p)}) diverged between batched and solo")


def test_batching_invariance_moe_engine():
    """The moe-family engine also pads safely: same wave, same result on
    repeat runs, and pad rows don't crash the dispatch path."""
    eng = _engine(CFG, slots=3, max_len=32, dispatch="spec-kernel")
    prompts = _prompts([4, 6, 5], CFG.vocab, seed=1)
    first = eng.run([Request(rid=i, prompt=p, max_new=3)
                     for i, p in enumerate(prompts)])
    again = eng.run([Request(rid=i, prompt=p, max_new=3)
                     for i, p in enumerate(prompts)])
    assert first == again


def test_truncation_is_explicit():
    """Hitting max_len with output budget left marks truncated=True and
    records a serve.truncate FailureEvent, never a silent cut."""
    eng = _engine(DENSE_CFG, slots=1, max_len=8)
    r = Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32), max_new=10)
    res = eng.run([r])
    assert r.truncated and r.done and not r.failed
    assert 0 < len(res[0]) < 10
    ev = [e for e in eng.events if e.site == "serve.truncate"]
    assert len(ev) == 1 and ev[0].outcome == "truncated"
    eng2 = _engine(DENSE_CFG, params=eng.params, slots=1, max_len=32)
    r2 = Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32), max_new=4)
    eng2.run([r2])
    assert not r2.truncated and not eng2.events


def test_wave_stats_accounting():
    """WaveStats counts committed tokens and MoE dispatch requests exactly
    (prefill + one issue per decode call per token)."""
    eng = _engine(CFG, slots=2, max_len=32, dispatch="spec-kernel")
    prompts = _prompts([4, 4], CFG.vocab, seed=2)
    eng.run([Request(rid=i, prompt=p, max_new=3)
             for i, p in enumerate(prompts)])
    assert len(eng.wave_stats) == 1
    st = eng.wave_stats[0]
    assert st.batch == 2 and st.tokens == 6 and st.truncated == 0
    per_tok = eng._moe_per_tok
    assert per_tok == CFG.n_layers * CFG.top_k
    # prefill: 2 rows x 4 positions; decode: 3 calls x 2 rows
    assert st.moe_requests == (2 * 4 + 3 * 2) * per_tok
    assert 0 <= st.moe_poison <= st.moe_requests
    assert st.wall_s > 0


def test_traffic_report():
    """The traffic harness serves the whole trace and reduces to a
    coherent report; the request trace itself is deterministic."""
    tc = TrafficConfig(n_requests=6, rate=500.0, prompt_len=(4, 6),
                       max_new=(2, 3), seed=3)
    a, arr_a = make_requests(tc, CFG.vocab)
    b, arr_b = make_requests(tc, CFG.vocab)
    assert all((x.prompt == y.prompt).all() and x.max_new == y.max_new
               for x, y in zip(a, b))
    np.testing.assert_array_equal(arr_a, arr_b)
    eng = _engine(CFG, slots=4, max_len=32, dispatch="spec-kernel")
    rep = run_traffic(eng, tc)
    assert rep.n_completed == 6 and rep.n_failed == 0
    assert rep.p95_ms >= rep.p50_ms > 0
    assert rep.tokens > 0 and rep.tok_s > 0
    assert rep.moe_requests > 0 and 0 <= rep.poison_rate <= 1
    assert len(rep.latencies_ms) == 6
    assert sum(w.tokens for w in rep.waves) == rep.tokens


# ---------------------------------------------------------------------------
# chaos: the degradation ladder under traffic
# ---------------------------------------------------------------------------


def test_chaos_slot_death_contained():
    """serve.slot kills one request; survivors keep exactly their full
    output, the victim commits nothing."""
    eng = _engine(DENSE_CFG, slots=4, max_len=32, wave_retries=1)
    reqs = [Request(rid=i, prompt=p, max_new=3)
            for i, p in enumerate(_prompts([4, 5, 4, 6], DENSE_CFG.vocab))]
    with faults.armed(FaultPlan({"serve.slot": 1.0}, seed=0, max_fires=1)):
        res = eng.run(reqs)
    failed = [r for r in reqs if r.failed]
    assert len(failed) == 1 and failed[0].out == []
    for r in reqs:
        if not r.failed:
            assert len(res[r.rid]) == 3, "survivor lost tokens"
    assert any(e.site == "serve.slot" and e.outcome == "failed"
               for e in eng.events)


def test_chaos_decode_timeout_retries_solo():
    """serve.decode tears the wave with no culprit: nothing commits from
    the torn wave, every request retries solo and completes clean."""
    eng = _engine(DENSE_CFG, slots=2, max_len=32, wave_retries=1)
    reqs = [Request(rid=i, prompt=p, max_new=3)
            for i, p in enumerate(_prompts([4, 5], DENSE_CFG.vocab))]
    with faults.armed(FaultPlan({"serve.decode": 1.0}, seed=0,
                                max_fires=1)):
        res = eng.run(reqs)
    assert all(not r.failed and len(res[r.rid]) == 3 for r in reqs), (
        "torn wave must not double or drop tokens")
    assert any(e.site == "serve.decode" and e.outcome == "retry"
               for e in eng.events)


def test_chaos_storm_shed_from_traffic():
    """serve.storm doubles the traffic with synthetic clones; they are
    served but shed: stats and results cover only real requests."""
    tc = TrafficConfig(n_requests=4, rate=500.0, prompt_len=(4, 5),
                       max_new=(2, 2), seed=5)
    eng = _engine(DENSE_CFG, slots=4, max_len=32)
    with faults.armed(FaultPlan({"serve.storm": 1.0}, seed=0,
                                max_fires=1)):
        rep = run_traffic(eng, tc)
    assert rep.n_completed == 4 and rep.n_failed == 0
    assert len(rep.latencies_ms) == 4
    assert rep.tokens == 4 * 2, "clone tokens must be shed from goodput"
    assert any(e.site == "serve.storm" and e.outcome == "shed"
               for e in eng.events)


def test_chaos_storm_in_engine_run():
    """serve.storm under Engine.run: clones served, shed from results."""
    eng = _engine(DENSE_CFG, slots=4, max_len=32)
    reqs = [Request(rid=i, prompt=p, max_new=2)
            for i, p in enumerate(_prompts([4, 5], DENSE_CFG.vocab))]
    with faults.armed(FaultPlan({"serve.storm": 1.0}, seed=0,
                                max_fires=1)):
        res = eng.run(reqs)
    assert sorted(res) == [0, 1] and all(len(v) == 2 for v in res.values())
    assert sum(w.batch for w in eng.wave_stats) == 4


# ---------------------------------------------------------------------------
# the card is the default
# ---------------------------------------------------------------------------


def test_no_card_raises_instead_of_serving_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(DENSE_CFG, device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "granite-34b"])


def test_launcher_serves_on_cpu(capsys):
    assert launch_serve.main(["--arch", "kimi-k2-1t-a32b", "--requests",
                              "3", "--max-new", "2", "--device",
                              "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on cpu" in out
