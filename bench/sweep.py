"""Find the knee of an open-loop cell: the highest rate it sustains.

    python3 -m bench.sweep --workload <name> --seed <n> --seconds 30 \
        --rates 4,6,8,10

In one process (weights drawn once), each rate runs one window of the
cell's mix at that rate, without the drain, and prints one JSON line:
requests due and served, the backlog still waiting when the window
closed, and time to first token of the first and second half of the
window.  A rate is sustained where the backlog stays under one wave and
the second half's tail is no longer than the first's.  The cell's mix
then takes a fixed rate below the knee; its own runs never sweep.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from bench.run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    _environment()
    import numpy as np
    import torch
    from bench import harness, serve
    from bench.traffic import Traffic
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cell = harness.build(harness.Bench(ROOT), args.workload, args.seed,
                         args.seconds, device)
    sync = serve.device_sync(device)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.mix, rate=rate)
        traffic = Traffic(mix, args.seed, cell.config["port"]["vocab"],
                          args.seconds)
        run = serve.RunData(mix, cell.config["port"], args.seconds)
        serve.serve_window(cell.engine, traffic, run, sync, drain=False)
        due = run.due_in_window()
        served = [r for r in due if r.stamps]
        half = run.t0 + args.seconds / 2

        def p95(rs):
            v = [(r.stamps[0] - r.due) * 1e3 for r in rs]
            return float(np.percentile(v, 95)) if v else None
        print(json.dumps({
            "rate": rate, "due": len(due), "served": len(served),
            "backlog": sum(1 for r in due if r.start is None),
            "waves": len(run.waves),
            "mean_wave": float(np.mean([len(w.rids) for w in run.waves]))
            if run.waves else 0,
            "ttft_p95_first_half_ms": p95([r for r in served
                                           if r.due < half]),
            "ttft_p95_second_half_ms": p95([r for r in served
                                            if r.due >= half]),
            "late_s": run.late_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
