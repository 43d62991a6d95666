"""Readings that set a cell's limits: the program and its control.

    python3 -m bench.calibrate --workload <name> --seeds 11,12,13 \
        --seconds 12 [--modes fp8,bf16] [--out FILE]

In one process, for each seed: draw the cell's weights, warm the engine,
serve a short window at the cell's own load, then judge what it served
against the float32 reference (the program's reading: the widest gap of
a served token's logit below the reference's best).  ``--modes fp8``
also runs the reference with float8 e4m3 matmuls over the same waves,
the control, whose reading is the widest gap of the token that float8
puts first, judged by the configuration's checks and limits as the
program is (``modes`` in the line); ``bf16`` does the same with the
served precision emulated, a witness.  One JSON line a seed goes to standard output (and to
``--out``), with each reading's distribution over the judged tokens.
The benchmark's own runs never run these.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    _environment()
    import numpy as np
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    bench = harness.Bench(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.build(bench, args.workload, seed, args.seconds,
                             device)
        run = harness.window(cell, args.seconds, traced=False)
        cell.engine = None
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        modes = [m for m in args.modes.split(",") if m]
        verdict = harness.judge(cell, run, seed, modes=modes,
                                log=lambda m: print(m, file=sys.stderr))
        first = np.array(verdict["first"], bool)

        def stats(values):
            v = np.array(values)
            if not v.size:
                return None
            return {"max": float(v.max()),
                    "p99": float(np.percentile(v, 99)),
                    "p90": float(np.percentile(v, 90)),
                    "mean": float(v.mean()),
                    "nonzero": float((v > 0).mean()),
                    "first_max": float(v[first].max()) if first.any()
                    else None}
        rec = {"workload": args.workload, "seed": seed,
               "judged": len(verdict["gaps"]),
               "program": stats(verdict["gaps"]),
               **{m: stats(g) for m, g in verdict["mode_gaps"].items()},
               "modes": verdict["modes"],
               "poison": verdict["poison"],
               "correct": verdict["correct"],
               "checks": verdict["checks"],
               "waves": len(run.waves),
               "serve_s": t1 - t0, "judge_s": time.perf_counter() - t1}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(line + "\n")
        del cell, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
