"""The trace reduction on events laid out by hand (nanoseconds)."""
import pytest

from bench import trace


def test_busy_ranges_and_idle_gaps():
    host = [("bench.window", 1000, 1000), ("bench.wave", 1000, 9000),
            ("serve.prefill", 1100, 3000), ("serve.decode_step", 4000, 5000),
            ("bench.route", 4000, 4100)]
    spans = [("bench.moe", 2000, 2600), ("bench.route", 4200, 4300),
             ("bench.moe", 4400, 4900)]
    work = [("gemm", 1500, 2000), ("moe_a", 2000, 2400),
            ("moe_b", 2300, 2600),            # overlaps moe_a
            ("route_k", 4200, 4300),          # the benchmark's own
            ("moe_c", 4400, 4900),
            ("late", 10500, 12000)]           # past the window
    t = trace.reduce(host, spans, work, seconds=10e-6)
    assert t.window_s == pytest.approx(10e-6)
    # busy: 1500-2600 and 4400-4900 and 10500-11000
    assert t.busy_s == pytest.approx((1100 + 500 + 500) * 1e-9)
    assert t.range_busy_s["bench.moe"] == pytest.approx(1100e-9)
    names = dict((n, v) for n, v in t.device_ops)
    assert "route_k" not in names and names["gemm"] == pytest.approx(5e-7)
    gaps = dict((n, v) for n, v in t.idle_gaps)
    # 1000-1500 prefill; 2600-4400: middle 3500 between model calls;
    # 4900-10500: middle 7700 inside the wave
    assert gaps["serve.prefill"] == pytest.approx(500e-9)
    assert gaps["engine (between model calls)"] == pytest.approx(
        (1800 + 5600) * 1e-9)
    assert sum(gaps.values()) + t.busy_s == pytest.approx(t.window_s)
    # the benchmark's own routing: its kernel's 100 ns (4200-4300, inside
    # a gap labelled otherwise); no idle gap's middle lies in the host
    # range 4000-4100
    assert t.own_s == pytest.approx(100e-9)


def test_gaps_inside_the_benchmarks_routing_are_its_own():
    host = [("bench.window", 0, 0), ("bench.wave", 0, 1000),
            ("bench.route", 300, 700)]
    spans = [("bench.route", 650, 690)]
    work = [("gemm", 0, 300), ("route_k", 650, 690), ("gemm", 700, 1000)]
    t = trace.reduce(host, spans, work, seconds=1e-6)
    assert t.busy_s == pytest.approx(600e-9)
    # the gap 300-700 lies in the host's routing range, its kernel too:
    # counted once
    assert t.own_s == pytest.approx(400e-9)
    assert dict(t.idle_gaps)["bench.route"] == pytest.approx(400e-9)


@pytest.mark.parametrize("own, want", ((0.0, 50.0), (0.2, 37.5)))
def test_device_idle_leaves_the_benchmarks_own_time_out(own, want):
    from bench.harness import Bench
    from bench.testing import ROOT
    read = Bench(ROOT).reader("device_idle.tok")
    run = _traced_run(0.0, {})
    run.trace.own_s = own
    # busy 0.5 s of a 1 s window
    assert read(run) == pytest.approx(want)


def test_no_window_mark_reads_nothing():
    assert trace.reduce([], [], [("k", 0, 5)], seconds=1.0) is None


def _traced_run(moe_busy, probes):
    from bench.serve import RunData
    port = {"family": "moe", "n_layers": 1, "d_model": 4, "n_heads": 1,
            "n_kv_heads": 1, "d_ff": 5, "vocab": 8, "n_experts": 3,
            "top_k": 1, "moe_d_ff": 5, "n_shared_experts": 0}
    run = RunData({}, port, 1.0, t0=10.0, t_end=11.0)
    run.trace = trace.TraceData(1.0, 0.5, {"bench.moe": moe_busy}, [], [])
    run.probes.update(probes)
    return run


def test_moe_roofline_counts_the_calls_in_the_window():
    import torch

    from bench import yardstick as Y
    from bench.harness import Bench
    from bench.testing import ROOT
    read = Bench(ROOT).reader("moe_roofline.tok")
    chosen = torch.tensor([[0], [2], [0]])
    run = _traced_run(1e-3, {"moe": [(10.5, 3, chosen), (12.0, 3, chosen)]})
    w = Y.moe_work(3, 2, d=4, n_experts=3, top_k=1, ff=5, shared_ff=0)
    assert read(run) == pytest.approx(
        Y.bf16_bound_s(w["flops"], w["bytes"]) / 1e-3 * 100)
    # nothing to read: no call inside the window, or no device time
    assert read(_traced_run(1e-3, {"moe": [(12.0, 3, chosen)]})) is None
    assert read(_traced_run(0.0, {"moe": [(10.5, 3, chosen)]})) is None
