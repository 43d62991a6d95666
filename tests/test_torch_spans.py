"""The port's in-memory spans and counters (``repro_torch.spans``) on the
serving path, on the CPU at smoke size, and their device marks on a
card.

The recorder is off unless switched on or, under the default switch,
while a ``torch.profiler`` session is active; off, no span site calls
into it.  On, a wave's spans nest as the module's table says, the MoE
layer's counters equal counts made from the port's own routing and
slots, the engine's row counts equal counts made from the requests'
``max_new``, and the program adds nothing to the profiler's trace.
"""
import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import base
from repro_torch.models import moe as moe_mod
from repro_torch.serve.engine import Engine, Request

CFG = dataclasses.replace(base.smoke(base.get("kimi_k2_1t_a32b")),
                          capacity_factor=0.5)
PROMPTS = (4, 7, 5)
MAX_NEW = (5, 3, 6)

#: each span's parent, by name (either where two are listed)
PARENTS = {
    "engine.wave": (None,),
    "engine.commit": ("engine.wave",),
    "model.prefill": ("engine.wave",),
    "model.decode_step": ("engine.wave",),
    "model.attn": ("model.prefill", "model.decode_step"),
    "model.head": ("model.prefill", "model.decode_step"),
    "moe.layer": ("model.prefill", "model.decode_step"),
    "attn.qkv": ("model.attn",), "attn.cache": ("model.attn",),
    "attn.expand": ("model.attn",), "attn.core": ("model.attn",),
    "attn.out": ("model.attn",),
    "moe.route": ("moe.layer",), "moe.dispatch": ("moe.layer",),
    "moe.ffn": ("moe.layer",), "moe.combine": ("moe.layer",),
    "moe.shared": ("moe.layer",),
}
PROGRAM = ("engine.", "model.", "attn.", "moe.")


@pytest.fixture(autouse=True)
def recorder():
    spans.enable(None)
    spans.reset()
    yield
    spans.enable(None)
    spans.reset()


@pytest.fixture(scope="module")
def engine():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield Engine(CFG, device="cpu", slots=3, max_len=32,
                 dispatch="spec-kernel")
    torch.set_num_threads(threads)


def _requests(max_new=MAX_NEW, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(1, CFG.vocab, n).astype(
        np.int32), max_new=m) for i, (n, m) in enumerate(zip(PROMPTS,
                                                           max_new))]


def _wave(engine, max_new=MAX_NEW):
    reqs = _requests(max_new)
    engine.run(reqs)
    return reqs


@pytest.mark.parametrize("switch", (False, None))
def test_off_records_nothing_and_calls_nothing(engine, monkeypatch,
                                               switch):
    spans.enable(switch)

    def refuse(*a, **kw):
        raise AssertionError("a span site called the recorder while off")
    for name in ("open", "close", "swap", "put", "set_step"):
        monkeypatch.setattr(spans, name, refuse)
    _wave(engine)
    assert spans.records() == [] and not spans.ON


def test_the_profiler_switches_the_default_on_and_off(engine):
    act = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=act):
        _wave(engine)
        assert not spans.ON        # checked a wave at a time
    names = {s.name for s in spans.records()}
    assert {"engine.wave", "model.decode_step", "moe.layer"} <= names
    n = len(spans.records())
    _wave(engine)
    assert len(spans.records()) == n


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_tree(engine, name):
    spans.enable(True)
    _wave(engine)
    recs = spans.records()
    by_id = {s.id: s for s in recs}
    mine = [s for s in recs if s.name == name]
    assert mine
    for s in mine:
        parent = by_id[s.parent].name if s.parent is not None else None
        assert parent in PARENTS[name], (s, parent)
        assert s.t0 <= s.t1
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
        assert s.wave == recs[0].wave        # one wave
        # a CPU run has no device marks
        assert s.d0 is None and s.d1 is None
    assert spans.dropped() == 0


def test_moe_counters_equal_the_ports_routing(engine, monkeypatch):
    """Call for call: ``experts_touched`` is ``unique(experts).numel()``
    of the port's routing, ``poisoned`` the slots it poisoned."""
    routed, slots = [], []
    real_route, real_dispatch = moe_mod._route, moe_mod.spec_dispatch_indices

    def route(params, x, top_k):
        out = real_route(params, x, top_k)
        routed.append(int(out[2].unique().numel()))
        return out

    def dispatch(*a, **kw):
        out = real_dispatch(*a, **kw)
        slots.append(int((out[0] < 0).sum()))
        return out
    monkeypatch.setattr(moe_mod, "_route", route)
    monkeypatch.setattr(moe_mod, "spec_dispatch_indices", dispatch)
    spans.enable(True)
    _wave(engine)
    layers = [s for s in spans.records() if s.name == "moe.layer"]
    assert [s.attrs["experts_touched"] for s in layers] == routed
    assert [s.attrs["poisoned"] for s in layers] == slots
    assert sum(slots) > 0, "no capacity race"
    for s in layers:
        assert s.attrs["experts_read"] == CFG.n_experts
        assert s.attrs["requests"] == s.attrs["rows"] * CFG.top_k


def test_poisoned_sum_to_the_waves_count(engine):
    spans.enable(True)
    engine.wave_stats.clear()
    for seed in range(2):
        engine.run(_requests(seed=seed))
    recs = spans.records()
    waves = sorted({s.wave for s in recs})
    assert len(waves) == len(engine.wave_stats) == 2
    for w, st in zip(waves, engine.wave_stats):
        got = sum(s.attrs["poisoned"] for s in recs
                  if s.name == "moe.layer" and s.wave == w)
        assert got == st.moe_poison
        wave = [s for s in recs if s.name == "engine.wave" and s.wave == w]
        assert len(wave) == 1
        # the span and WaveStats.wall_s read the same pair of clocks
        assert (wave[0].t1 - wave[0].t0) / 1e9 == st.wall_s
        assert wave[0].attrs["batch"] == st.batch
        assert wave[0].attrs["tokens"] == st.tokens


@pytest.mark.parametrize("max_new, max_len", (
    (MAX_NEW, 32), ((1, 9, 4), 32), ((6, 6, 6), 32),
    ((8, 2, 9), 12)))          # the longest prompt hits max_len
def test_rows_and_live_rows(engine, max_new, max_len):
    spans.enable(True)
    eng = Engine(CFG, params=engine.params, device="cpu", slots=3,
                 max_len=max_len, dispatch="spec-kernel")
    reqs = _wave(eng, max_new)
    recs = spans.records()
    commits = [s for s in recs if s.name == "engine.commit"]
    steps = [s for s in recs if s.name == "model.decode_step"]
    counted = [s for s in commits if "rows" in s.attrs]
    assert len(counted) == len(steps)
    assert [s.step for s in steps] == [s.step for s in counted]
    for s in counted:
        assert s.attrs["rows"] == len(reqs)
        assert s.attrs["live_rows"] == sum(s.step + 1 < m for m in max_new)
    truncated = any(r.truncated for r in reqs)
    assert truncated == (max_len == 12)
    assert len(commits) == len(counted) + truncated


def test_the_program_adds_no_profiler_event(engine):
    act = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=act) as prof:
        _wave(engine)
    assert any(s.name == "moe.ffn" for s in spans.records())
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith(PROGRAM)]


def test_moe_layer_leaves_the_benchmarks_routing_out(engine):
    """Under the traced run's wrapper (``bench.trace.layer_ranges``),
    which routes every token again before the call, ``moe.layer``
    opens after that routing has ended."""
    from bench import trace
    probes = {}
    spans.enable(True)
    with trace.layer_ranges(probes):
        _wave(engine)
    layers = [s for s in spans.records() if s.name == "moe.layer"]
    assert len(layers) == len(probes["moe"]) > 0
    for s, (t_routed, rows, chosen) in zip(layers, probes["moe"]):
        assert s.t0 >= t_routed * 1e9
        assert s.attrs["rows"] == rows
        assert s.attrs["experts_touched"] == int(chosen.unique().numel())


def test_to_profiler_ns_meets_a_record_function_mark():
    act = [torch.profiler.ProfilerActivity.CPU]
    spans.enable(True)
    with torch.profiler.profile(activities=act) as prof:
        with torch.profiler.record_function("warm"):
            pass
        marks = []
        for i in range(3):
            time.sleep(0.01)
            s = spans.open("test.mark")
            with torch.profiler.record_function(f"mark{i}"):
                pass
            spans.close(s)
            marks.append(s)
    starts = {ev.name(): ev.start_ns()
              for ev in prof.profiler.kineto_results.events()}
    for i, s in enumerate(marks):
        assert abs(starts[f"mark{i}"] - spans.to_profiler_ns(s.t0)) < 1e6


def test_summary_self_time_and_the_bounded_buffer(monkeypatch):
    spans.enable(True)
    a = spans.open("a")
    b = spans.open("b", rows=1)
    c = spans.swap(b, "c")
    spans.close(c)
    spans.close(a)
    summ = spans.summary()
    assert {k: v["count"] for k, v in summ.items()} == {"a": 1, "b": 1,
                                                       "c": 1}
    assert b.t1 == c.t0 and b.parent == c.parent == a.id
    inner = (c.t1 - b.t0) / 1e9
    assert summ["a"]["self_s"] == pytest.approx(summ["a"]["host_s"] - inner)
    assert summ["b"]["self_s"] == summ["b"]["host_s"]
    assert summ["a"]["device_s"] == 0.0
    from collections import deque
    monkeypatch.setattr(spans._REC, "buf", deque(maxlen=2))
    for _ in range(5):
        spans.close(spans.open("d"))
    assert spans.dropped() == 3 and len(spans.records()) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("switch", (True, None))
def test_device_marks_lie_inside_the_synced_call(switch):
    """On a card: a decode call's device marks lie inside the call's
    synchronised host interval (within the anchor's error), and the
    attention and MoE intervals inside it do not overlap; switched on
    (resolved at each wave's end) and under the profiler (resolved when
    read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    eng = Engine(cfg, device=dev, slots=3, max_len=32,
                 dispatch="spec-kernel")
    calls = []
    model = eng.model

    class Synced:
        def __getattr__(self, name):
            return getattr(model, name)

        def decode_step(self, *a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter_ns()
            out = model.decode_step(*a, **kw)
            torch.cuda.synchronize(dev)
            calls.append((t0, time.perf_counter_ns()))
            return out
    eng.model = Synced()
    eng.run(_requests())            # builds and loads the kernels
    spans.enable(switch)
    calls.clear()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with (torch.profiler.profile(activities=act) if switch is None
          else contextlib.nullcontext()):
        eng.run(_requests())
        eng.run(_requests())
    recs = spans.records()
    err = 50_000                    # ns: the anchor's error and more
    steps = [s for s in recs if s.name == "model.decode_step"]
    assert len(steps) == len(calls) > 0
    for s, (t0, t1) in zip(steps, calls):
        assert t0 - err <= s.d0 <= s.d1 <= t1 + err, (s, t0, t1)
        inner = sorted((c.d0, c.d1) for c in recs
                       if c.parent == s.id
                       and c.name in ("model.attn", "moe.layer"))
        assert len(inner) == 2 * cfg.n_layers
        for (a0, a1), (b0, b1) in zip(inner, inner[1:]):
            assert a0 <= a1 <= b0 <= b1
        assert s.d0 <= inner[0][0] and inner[-1][1] <= s.d1
