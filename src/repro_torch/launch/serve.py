"""Serving launcher: batched requests against a smoke config.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch kimi-k2-1t-a32b --requests 8 --max-new 16 --device cpu

The counterpart of the JAX package's ``launch/serve.py``, with the same
flags plus ``--device`` (``cuda`` by default; without a card that raises
instead of running on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import get, smoke
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke(get(args.arch))
    eng = Engine(cfg, slots=args.slots, max_len=64 + args.max_new,
                 device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, rng.integers(4, 32)),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = eng.run(reqs)
    dt = time.perf_counter() - t0
    n = sum(len(v) for v in results.values())
    print(f"{len(reqs)} requests, {n} tokens, {dt:.2f}s "
          f"({n / dt:.1f} tok/s) on {eng.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
