"""Run one cell of the benchmark once and print its result line.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line on standard output is the
result object; the numbers the check compares, each beside its limit,
are the last lines on standard error.  Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches at fixed paths inside the checkout; the allocator's
    expandable segments, so that waves of changing shapes do not
    fragment the card's memory."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from bench.harness import Bench, forbidden_modules, run_cell
    marks = {"imports_s": time.perf_counter() - T_START}
    chips = Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(f"[bench] {msg}", file=sys.stderr, flush=True)
    torch.cuda.init()
    marks["cuda_start_s"] = time.perf_counter() - T_START \
        - marks["imports_s"]
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), T_START,
                      log=log, phases=marks)
    # once the window has closed, in the process that prints the result
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
