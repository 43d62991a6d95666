"""Drive the full dry-run matrix: every (arch x shape) x {single,
multi-pod} as its own subprocess (each joins its own fake process group),
collecting JSON artifacts into ``results/dryrun_torch/`` (the reference
writes ``results/dryrun/``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all [--only arch:shape]
    PYTHONPATH=src python -m repro_torch.launch.dryrun_all --mesh single

The counterpart of the JAX package's ``launch/dryrun_all.py``, with its
per-cell timeout.  The SSM scans are counted a step at a time and
multiplied by their trip count (:func:`repro_torch.launch.dryrun.
scan_shortcut`), so the ssm and hybrid cells take seconds, as the
others do; a cell that fails or times out is reported with the end of
its error output, and nothing is skipped silently.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs.base import ASSIGNED, get
from repro_torch.launch.dryrun import SHAPES, shape_skip_reason

RESULTS = os.path.join(os.path.dirname(__file__), "../../..", "results",
                       "dryrun_torch")


def cell_path(arch: str, shape: str, mesh: str) -> str:
    return os.path.join(RESULTS, f"{arch}__{shape}__{mesh}.json")


def run_matrix(mesh_kinds=("single", "multi"), only=None,
               timeout: int = 1200, force: bool = False) -> int:
    os.makedirs(RESULTS, exist_ok=True)
    failures = []
    for arch in ASSIGNED:
        cfg = get(arch)
        name = cfg.name
        for shape in SHAPES:
            if only and f"{name}:{shape}" not in only \
                    and f"{arch}:{shape}" not in only:
                continue
            for mesh in mesh_kinds:
                out = cell_path(arch, shape, mesh)
                if os.path.exists(out) and not force:
                    continue
                skip = shape_skip_reason(cfg, shape)
                if skip:
                    with open(out, "w") as fh:
                        json.dump({"arch": name, "shape": shape,
                                   "mesh": mesh, "skipped": skip}, fh,
                                  indent=2)
                    print(f"[skip] {name} x {shape} x {mesh}: {skip}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", out]
                if mesh == "multi":
                    cmd.append("--multi-pod")
                t0 = time.time()
                print(f"[run ] {name} x {shape} x {mesh} ...", flush=True)
                try:
                    p = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=timeout)
                    ok = p.returncode == 0 and os.path.exists(out)
                except subprocess.TimeoutExpired:
                    ok, p = False, None
                dt = time.time() - t0
                if ok:
                    print(f"       ok in {dt:.0f}s")
                else:
                    failures.append((name, shape, mesh))
                    tail = (p.stderr[-2000:] if p else "TIMEOUT")
                    print(f"       FAILED in {dt:.0f}s\n{tail}")
    if failures:
        print("\nFAILURES:", failures)
    return len(failures)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--only", nargs="*", default=None,
                    help="arch:shape filters")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=1200)
    args = ap.parse_args(argv)
    kinds = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    return run_matrix(kinds, args.only, args.timeout, args.force)


if __name__ == "__main__":
    sys.exit(main())
