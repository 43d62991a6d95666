"""The readers of the port's own spans: nothing to read gives None, a
recorder laid out by hand gives the value its spans hold inside the
window and no other, and ``live_row_share`` on a traced CPU run equals
the ratio worked out from the run's waves and requests alone."""
import time

import pytest
import torch

from bench import harness
from bench.serve import RunData
from bench.testing import ROOT, smoke_root
from repro_torch import spans

NEW = ("decode_issue_ms", "engine_commit_ms", "attn_step_ms",
       "moe_step_ms", "moe_touched_share", "live_row_share.tok",
       "live_row_share.ttft")
T0 = 1000.0                      # the window, seconds on the host clock


@pytest.fixture(autouse=True)
def recorder():
    spans.enable(None)
    spans.reset()
    yield
    spans.enable(None)
    spans.reset()


def _read(name, run):
    return harness.Bench(ROOT).reader(name)(run)


def _run():
    return RunData({}, {}, 1.0, t0=T0, t_end=T0 + 1.0)


def _span(name, t0_ms, t1_ms, parent=None, device=None, **attrs):
    """A closed span at ``t0_ms``..``t1_ms`` into the window, in the
    recorder's buffer; ``device``: its device interval, in ms too."""
    s = spans.Span()
    s.id = len(spans._REC.buf)
    s.name, s.parent, s.wave, s.step = name, parent, 0, 0
    s.t0 = int(round((T0 + t0_ms / 1e3) * 1e9))
    s.t1 = int(round((T0 + t1_ms / 1e3) * 1e9))
    s.d0 = s.d1 = None
    if device is not None:
        s.d0, s.d1 = (int(round((T0 + t / 1e3) * 1e9)) for t in device)
    s.attrs, s.ev0, s.ev1 = attrs, None, None
    spans._REC.buf.append(s)
    return s


def _step(at_ms, attn_ms, moe_ms, touched, rows, live):
    """One decode step as the port records it, ``at_ms`` into the
    window: its commit (2 ms), the call (4 ms of issue), the attention
    and MoE sublayers with device marks, the head."""
    _span("engine.commit", at_ms, at_ms + 2, rows=rows, live_rows=live)
    step = _span("model.decode_step", at_ms + 2, at_ms + 6,
                 device=(at_ms + 2.5, at_ms + 9))
    _span("model.attn", at_ms + 2.1, at_ms + 3, parent=step.id,
          device=(at_ms + 2.5, at_ms + 2.5 + attn_ms))
    _span("moe.layer", at_ms + 3, at_ms + 5, parent=step.id,
          device=(at_ms + 3, at_ms + 3 + moe_ms), rows=rows,
          requests=rows * 8, experts_read=384, experts_touched=touched,
          poisoned=0)
    _span("model.head", at_ms + 5, at_ms + 6, parent=step.id,
          device=(at_ms + 8, at_ms + 9))


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name):
    assert _read(name, _run()) is None
    # spans outside the window only: before it, and past its end
    _step(-50.0, 1.0, 2.0, 10, 4, 2)
    _step(1000.5, 1.0, 2.0, 10, 4, 2)
    assert _read(name, _run()) is None


WANT = {"decode_issue_ms": 4.0, "engine_commit_ms": 2.0,
        "attn_step_ms": (1.0 + 3.0) / 2, "moe_step_ms": (2.0 + 4.0) / 2,
        "moe_touched_share": (100 + 200) / (2 * 384) * 100,
        "live_row_share.tok": (3 + 1) / (4 + 4) * 100,
        "live_row_share.ttft": (3 + 1) / (4 + 4) * 100}


@pytest.mark.parametrize("name", NEW)
def test_reads_the_window_only(name):
    _step(-50.0, 7.0, 7.0, 300, 4, 4)              # before the window
    _step(10.0, 1.0, 2.0, 100, 4, 3)
    _step(30.0, 3.0, 4.0, 200, 4, 1)
    # a prefill's sublayers are not a decode call's
    pre = _span("model.prefill", 40.0, 60.0, device=(40.0, 80.0))
    _span("model.attn", 41.0, 42.0, parent=pre.id, device=(41.0, 70.0))
    _span("moe.layer", 42.0, 43.0, parent=pre.id, device=(70.0, 80.0),
          rows=64, requests=512, experts_read=384, experts_touched=384,
          poisoned=3)
    _span("engine.commit", 90.0, 91.0)             # truncated: no decode
    _step(999.5, 9.0, 9.0, 384, 4, 4)              # across its end
    assert _read(name, _run()) == pytest.approx(WANT[name])


def test_a_step_without_device_marks_is_left_out_of_device_time():
    _step(10.0, 1.0, 2.0, 100, 4, 3)
    step = _span("model.decode_step", 20.0, 24.0)
    _span("model.attn", 20.5, 21.0, parent=step.id)
    _span("moe.layer", 21.0, 22.0, parent=step.id, rows=4, requests=32,
          experts_read=384, experts_touched=5, poisoned=0)
    assert _read("attn_step_ms", _run()) == pytest.approx(1.0)
    assert _read("moe_step_ms", _run()) == pytest.approx(2.0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield smoke_root(tmp_path_factory.mktemp("spans"))
    torch.set_num_threads(threads)


def _live_share_of(run):
    """Of the window's decode calls' rows, the share whose request still
    needs the call's token (decode step s of a wave computes output
    s + 1), from the run's own records."""
    step, rows, live = {}, 0, 0
    for c in run.calls:
        s = step.get(c.wave, -1)
        step[c.wave] = s + 1
        if c.kind != "decode" or not (run.t0 <= c.t0 and c.t1 <= run.t_end):
            continue
        reqs = [run.requests[rid] for rid in run.waves[c.wave].rids]
        rows += len(reqs)
        live += sum(s + 1 < r.max_new for r in reqs)
    return live / rows * 100


@pytest.mark.parametrize("cell, metric", (
    ("smoke.moe-closed", "live_row_share.tok"),
    ("smoke.moe-open", "live_row_share.ttft")))
def test_live_row_share_equals_the_runs_own_count(root, cell, metric):
    bench = harness.Bench(root)
    built = harness.build(bench, cell, 2**31 + 29, 0.6, torch.device("cpu"))
    run = harness.window(built, 0.6, True)
    n = len(run.calls_in_window("decode"))
    assert n
    # the window's last call may close past its end, after the commit
    # before it: one step's rows apart
    got = bench.reader(metric)(run)
    assert got == pytest.approx(_live_share_of(run), abs=100 / n)
    assert 0 < got <= 100
    # a window that holds every call: the same steps on both sides
    run.t_end = time.perf_counter()
    assert bench.reader(metric)(run) == pytest.approx(_live_share_of(run))
    # the recorder followed the profiler: on in the window, off after
    assert not spans.ON
    result = harness.read_metrics(bench, cell, "per_layer", run)
    for name in ("decode_issue_ms", "engine_commit_ms", "moe_touched_share"):
        assert result[name]["value"] > 0
    # no device marks on the CPU
    assert "attn_step_ms" not in result and "moe_step_ms" not in result
    assert result["decode_issue_ms"]["value"] <= \
        result["decode_step_ms"]["value"]
