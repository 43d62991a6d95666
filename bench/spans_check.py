"""Cross-checks of the port's spans on a card, and their cost.

    python3 -m bench.spans_check --workload <cell> --seed <n> \\
        --seconds 40 --mode trace [--out FILE]
    python3 -m bench.spans_check --workload <cell> --seed <n> \\
        --seconds 40 --mode cost|trace-cost --pairs 3 [--out FILE]

``trace``: one traced window as ``--trace 1`` runs it, and then the
per-layer metrics, the recorder's ``summary()``, and the checks: each MoE
call's ``experts_touched`` against the experts of the benchmark's own
top-k in ``bench.route`` (a call where they differ is shown to hold a
tie between the k-th and the (k+1)-th router logit of some row, counted
inside a ``bench.route`` range of this script's, so that it stays out of
the layer's and the device's busy time); ``decode_issue_ms`` and
``attn_step_ms + moe_step_ms`` against ``decode_step_ms``;
``live_row_share`` against the ratio worked out from the run's waves and
requests; no event of the trace named as a program span; the judge.

``cost``: one built cell, untraced windows in turns with the recorder
at its default (off without a profiler) and switched on, ``--pairs``
pairs, each window's ``decode_step_ms``, ``tpot_p95_ms`` and the cell's
other end-to-end metrics.  ``trace-cost``: the same with traced windows,
the recorder switched off and at its default (on under the profiler),
each window's per-layer metrics.

The result is one JSON object, printed last and written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from bench.run import ROOT, _environment

PROGRAM = ("engine.", "model.", "attn.", "moe.")


def _tie_counter(ties):
    """Wrap ``moe.moe_spec``: before each call, count the rows whose
    k-th and (k+1)-th router logits are equal (on the device, inside a
    ``bench.route`` range)."""
    import torch
    from repro_torch.models import moe
    saved = moe.moe_spec

    def moe_spec(params, x, *, n_experts, top_k, **kw):
        with torch.profiler.record_function("bench.route"):
            v = torch.topk(x @ params["router"], top_k + 1, dim=-1).values
            ties.append((v[:, top_k - 1] == v[:, top_k]).sum())
        return saved(params, x, n_experts=n_experts, top_k=top_k, **kw)
    moe.moe_spec = moe_spec
    return saved


def _live_share(run):
    step, rows, live = {}, 0, 0
    for c in run.calls:
        s = step.get(c.wave, -1)
        step[c.wave] = s + 1
        if c.kind != "decode" or not (run.t0 <= c.t0 and c.t1 <= run.t_end):
            continue
        reqs = [run.requests[rid] for rid in run.waves[c.wave].rids]
        rows += len(reqs)
        live += sum(s + 1 < r.max_new for r in reqs)
    return live / rows * 100 if rows else None


def traced(bench, cell, args, device, log):
    import torch
    from bench import serve, trace
    from bench.harness import judge, read_metrics
    from repro_torch import spans
    from repro_torch.models import moe
    ties = []
    saved = _tie_counter(ties)
    sync = serve.device_sync(device)
    run = serve.RunData(cell.mix, cell.config["port"], args.seconds)
    run.probes["sm_clock_hz"] = trace.sm_clock_hz()
    try:
        with trace.layer_ranges(run.probes), trace.profiler() as prof:
            serve.serve_window(cell.engine, cell.traffic, run, sync)
            sync()
    finally:
        moe.moe_spec = saved
    events = trace.events_of(prof)
    run.trace = trace.reduce(*events, seconds=args.seconds)
    named = sorted({n for part in events for n, _, _ in part
                    if n.startswith(PROGRAM)})
    metrics = read_metrics(bench, args.workload, "per_layer", run)
    recs = spans.records()
    layers = [s for s in recs if s.name == "moe.layer"]
    probes = run.probes["moe"]
    tie_n = [int(t) for t in ties]
    calls = len(probes) == len(layers) == len(tie_n)
    same = diff = diff_tied = 0
    examples = []
    for s, (t, n, chosen), k in zip(layers, probes, tie_n):
        if not run.t0 <= t < run.t_end:
            continue
        ref = int(chosen.reshape(-1).unique().numel())
        if s.attrs["experts_touched"] == ref:
            same += 1
            continue
        diff += 1
        diff_tied += k > 0
        if len(examples) < 10:
            examples.append({"rows": n, "port": s.attrs["experts_touched"],
                             "bench_route": ref, "tied_rows": k})
    v = {k: m["value"] for k, m in metrics.items()}
    checks = {
        "calls_paired": calls,
        "touched_equal_share": same / max(1, same + diff),
        "touched_differ": diff, "touched_differ_tied": diff_tied,
        "touched_examples": examples,
        "issue_le_step": v.get("decode_issue_ms", 0) <= v.get(
            "decode_step_ms", 0),
        "attn_moe_le_step": v.get("attn_step_ms", 0) + v.get(
            "moe_step_ms", 0) <= v.get("decode_step_ms", 0),
        "live_row_share_run": _live_share(run),
        "program_names_in_trace": named,
        "dropped": spans.dropped(),
    }
    device_ops = run.trace.device_ops
    checks["program_names_in_device_ops"] = [
        n for n, _ in device_ops if n.startswith(PROGRAM)]
    cell.engine = None
    torch.cuda.empty_cache()
    verdict = judge(cell, run, args.seed, log=log)
    return {"correct": verdict["correct"], "metrics": v,
            "summary": spans.summary(), "checks": checks,
            "busy_s": run.trace.busy_s, "window_s": run.trace.window_s,
            "own_s": run.trace.own_s, "device_ops": device_ops,
            "idle_gaps": run.trace.idle_gaps,
            "waves": len(run.waves)}


def cost(bench, cell, args, device, log):
    from bench import harness
    from repro_torch import spans
    traced = args.mode == "trace-cost"
    # untraced: the default records nothing; traced: it records
    base, on = (False, None) if traced else (None, True)
    if traced:
        names = [m["name"] for m in bench.metrics(args.workload,
                                                  "per_layer")]
    else:
        names = [m["name"] for m in bench.metrics(args.workload,
                                                  "end_to_end")
                 if m["name"] != "setup_s"] + ["decode_step_ms"]
    if traced:
        # the process's first profiled window starts the profiler's own
        # machinery: left out of the pairs
        spans.enable(None)
        harness.window(cell, min(5.0, args.seconds), True)
    rows = []
    for i in range(args.pairs):
        for switch in ((base, on) if i % 2 == 0 else (on, base)):
            spans.enable(switch)
            spans.reset()
            run = harness.window(cell, args.seconds, traced)
            row = {"pair": i, "recorder": "off" if switch is False else
                   "on" if switch else "default",
                   "spans": len(spans.records())}
            for name in names:
                row[name] = bench.reader(name)(run)
            if traced:
                row["idle_gaps"] = run.trace.idle_gaps
            log(json.dumps(row))
            rows.append(row)
    spans.enable(None)
    return {"runs": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("trace", "cost", "trace-cost"),
                    required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _environment()
    import torch
    from bench.harness import Bench, build
    if not torch.cuda.is_available():
        print("bench.spans_check: needs a CUDA device", file=sys.stderr)
        return 2

    def log(msg):
        print(f"[spans] {msg}", file=sys.stderr, flush=True)
    device = torch.device("cuda")
    bench = Bench(ROOT)
    t0 = time.perf_counter()
    cell = build(bench, args.workload, args.seed, args.seconds, device)
    log(f"set-up {time.perf_counter() - t0:.1f} s")
    fn = traced if args.mode == "trace" else cost
    out = {"workload": args.workload, "seed": args.seed, "mode": args.mode,
           "seconds": args.seconds,
           "device": torch.cuda.get_device_name(device)}
    out.update(fn(bench, cell, args, device, log))
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
