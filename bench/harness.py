"""One run of one cell: set-up, the window, the metrics and the judge.

Everything a cell needs is found by name under the benchmark's root:
``BENCHMARK.json`` names the cell's configuration file and traffic mix;
the mix is ``bench/traffic/<mix>.json``; each metric's reader is
``bench/metrics/<name>.py`` or, for a metric split by the end-to-end
metric it moves (``prefill_ms_per_ktok.tok``), the reader of the part
before the first dot; the configuration names its plain reference,
``bench/references/<name>.py``.  A later cell, mix, configuration or
metric is new files and entries, and no edit here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import serve, trace
from .traffic import Traffic, load_mix
from .weights import count_params, draw_params, group_pattern

#: top-level module names the port must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` passes."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.data = self.root / "bench"

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> Dict:
        return load_mix(self.data / "traffic" / f"{name}.json")

    def metrics(self, cell: str, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if kind == "end_to_end":
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, name: str):
        """The metric's ``read(run)``."""
        base = self.data / "metrics"
        for stem in (name, name.split(".")[0]):
            path = base / f"{stem}.py"
            if path.exists():
                return load_module(path, f"bench_metric_{stem}").read
        raise FileNotFoundError(f"no reader for metric {name} in {base}")

    def reference(self, name: str):
        return load_module(self.data / "references" / f"{name}.py",
                           f"bench_reference_{name}")


def arch_config(port: Dict):
    """The port's ``ArchConfig`` of a configuration file's ``port``."""
    from repro_torch.configs.base import ArchConfig
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in port.items() if k in fields})


def seed_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


@dataclasses.dataclass
class Cell:
    """A cell built for a run: its files, weights and engine."""
    bench: Bench
    config: Dict
    mix: Dict
    traffic: Traffic
    params: Dict
    engine: object
    max_len: int


def build(bench: Bench, workload: str, seed: int, seconds: float,
          device, phases: Dict = None) -> Cell:
    """Draw the cell's weights from ``seed``, build the engine, warm it;
    each step's seconds (synced) go into ``phases``."""
    from repro_torch.kernels import build as kernel_build
    from repro_torch.serve.engine import Engine
    phases = {} if phases is None else phases
    sync = serve.device_sync(device)
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        phases[name] = now - t
        t = now
    w = bench.cell(workload)
    config = bench.config(w["config"])
    mix = bench.mix(w["traffic"])
    port = config["port"]
    traffic = Traffic(mix, seed, port["vocab"], seconds)
    params = draw_params(port, seed_generator(seed, device), device)
    lap("weights_s")
    max_len = traffic.longest_prompt() + traffic.longest_output() + 1
    engine = Engine(arch_config(port), params, slots=mix["slots"],
                    max_len=max_len, dispatch="spec-kernel", device=device)
    lap("engine_s")
    built = set(kernel_build.BUILD_LOG)
    serve.warm(engine, traffic, mix["slots"], sync)
    lap("warm_s")
    # a first run in a checkout compiles the kernels inside its warm wave
    phases["kernels_built"] = sorted(set(kernel_build.BUILD_LOG) - built)
    return Cell(bench, config, mix, traffic, params, engine, max_len)


def window(cell: Cell, seconds: float, traced: bool) -> serve.RunData:
    """The measured window (and, with ``traced``, its profile)."""
    device = cell.params["embed"].device
    sync = serve.device_sync(device)
    run = serve.RunData(cell.mix, cell.config["port"], seconds)
    if not traced:
        serve.serve_window(cell.engine, cell.traffic, run, sync)
        return run
    run.probes["sm_clock_hz"] = trace.sm_clock_hz() \
        if device.type == "cuda" else None
    with trace.layer_ranges(run.probes), trace.profiler() as prof:
        serve.serve_window(cell.engine, cell.traffic, run, sync)
        sync()
    t0 = time.perf_counter()
    run.trace = trace.reduce(*trace.events_of(prof), seconds=seconds)
    run.probes["reduce_s"] = time.perf_counter() - t0
    return run


def read_metrics(bench: Bench, cell: str, kind: str,
                 run: serve.RunData) -> Dict:
    out = {}
    for m in bench.metrics(cell, kind):
        if m["name"] == "setup_s":
            continue
        value = bench.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, log=print, phases: Dict = None) -> Dict:
    """One run of one cell; returns the result object.  ``phases``: the
    set-up's steps timed before the call (seconds), logged with the
    rest."""
    bench = Bench(root)
    phases = dict(phases or {})
    phases["before_cell_s"] = time.perf_counter() - t_start \
        - sum(phases.values())
    cell = build(bench, workload, seed, seconds, device, phases)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: {count_params(cell.params) / 1e9:.3f}e9 "
        f"parameters, slots {cell.mix['slots']}, max_len {cell.max_len}; "
        + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in phases.items()))
    run = window(cell, seconds, traced)
    log(f"window: {len(run.waves)} waves, {len(run.due_in_window())} "
        f"requests due, {time.perf_counter() - run.t_end:.1f} s past its "
        f"close; the generator ran at most {run.late_s * 1e3:.3f} ms late"
        + (f"; trace of {run.trace.events} events reduced in "
           f"{run.probes['reduce_s']:.1f} s" if run.trace else ""))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    kind = "per_layer" if traced else "end_to_end"
    metrics = read_metrics(bench, workload, kind, run)
    if not traced:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    # the program's state goes before the reference runs
    cell.engine = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = judge(cell, run, seed, log=log)
    result = {
        "correct": verdict["correct"],
        "attempted": len(run.due_in_window()),
        "failed": verdict["checks"]["failed_requests"]["value"],
        "metrics": metrics,
        "device": device_record(device, peak),
    }
    if traced and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = verdict["checks"]
    return result


def device_record(device, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


# ---------------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------------


def sample(run: serve.RunData, mix: Dict, seed: int) -> Dict[int, List[int]]:
    """The waves the reference follows and, in each, the requests it
    judges: the wave of the request that served the most tokens, with it,
    and the rest drawn from the seed."""
    check = mix["check"]
    ok = [i for i, w in enumerate(run.waves) if w.ok]
    if not ok:
        return {}
    rng = np.random.default_rng([int(seed) % (1 << 32), 3])
    done = [r for r in run.requests.values()
            if r.wave is not None and run.waves[r.wave].ok]
    longest = max(len(r.out) for r in done)
    first = [r for r in done if len(r.out) == longest]
    top = first[int(rng.integers(len(first)))]
    waves = [top.wave] + [int(i) for i in rng.permutation(
        [i for i in ok if i != top.wave])[:check["waves"] - 1]]
    picked = {}
    for wi in waves:
        rids = run.waves[wi].rids
        others = [r for r in rids if r != top.rid]
        n = check["requests"] - (1 if wi == top.wave else 0)
        chosen = [int(r) for r in rng.permutation(others)[:n]]
        picked[wi] = ([top.rid] if wi == top.wave else []) + chosen
    return picked


def wave_input(run: serve.RunData, wi: int, cols: int, max_len: int,
               device) -> Dict:
    """The wave as the reference takes it: the prompts left-padded with
    token 0 to the longest (the engine's layout, worked out again), then
    the tokens the program fed its decode steps, up to ``cols`` columns."""
    w = run.waves[wi]
    prompts = [run.requests[r].prompt for r in w.rids]
    plen = max(len(p) for p in prompts)
    b = len(prompts)
    toks = np.zeros((b, cols), np.int64)
    pads = np.zeros((b,), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):plen] = p
        pads[i] = plen - len(p)
    for s in range(cols - plen):
        toks[:, plen + s] = w.fed[s]
    return {"tokens": torch.from_numpy(toks).to(device),
            "pads": torch.from_numpy(pads).to(device), "plen": plen,
            "max_len": max_len}


def gap_readings(gaps: Sequence[float]) -> Dict[str, float]:
    """The numbers a configuration's check may compare: the widest gap of
    a served token's logit below the reference's best, and the gap that
    nine tenths of the served tokens stay within."""
    if not gaps:
        return {"logit_gap": float("inf"), "logit_gap_p90": float("inf")}
    return {"logit_gap": float(max(gaps)),
            "logit_gap_p90": float(np.percentile(gaps, 90))}


def judge(cell: Cell, run: serve.RunData, seed: int,
          modes: Sequence[str] = (), log=print) -> Dict:
    """Hold what the timed path served against the plain reference.

    ``modes``: readings besides the program's, over the same waves
    (calibration only): ``"fp8"`` the control, ``"bf16"`` the witness of
    the served precision.  Each reads the float32 reference's gap of the
    token that the mode's own logits put first."""
    ref = cell.bench.reference(cell.config["reference"])
    port = cell.config["port"]
    pattern = group_pattern(port)
    device = cell.params["embed"].device
    limits = cell.config["check"]
    due = run.due_in_window()
    failed = sum(1 for r in due if r.failed or r.truncated
                 or len(r.out) != r.max_new)
    mismatch = 0
    gaps: List[float] = []
    first: List[bool] = []
    mode_gaps: Dict[str, List[float]] = {m: [] for m in modes}
    poison = {"reference": 0, "program": 0}
    picked = sample(run, cell.mix, seed)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    for wi, rids in picked.items():
        w = run.waves[wi]
        plen = max(len(run.requests[r].prompt) for r in w.rids)
        longest = max(len(run.requests[r].out) for r in rids)
        wave = wave_input(run, wi, plen + longest - 1, cell.max_len, device)
        if w.prompt_tokens is None or not np.array_equal(
                w.prompt_tokens, wave["tokens"][:, :plen].cpu().numpy()):
            mismatch += 1
        rows, cols_at, served = [], [], []
        for rid in rids:
            r = run.requests[rid]
            row = w.rids.index(rid)
            for j, tok in enumerate(r.out):
                # decode step j's input is the token served j-th
                if j < len(w.fed) and int(w.fed[j][row]) != tok:
                    mismatch += 1
                rows.append(row)
                cols_at.append(plen - 1 + j)
                served.append(tok)
                first.append(j == 0)
        at = (torch.tensor(rows, device=device),
              torch.tensor(cols_at, device=device))
        stats: Dict = {}
        with torch.no_grad():
            hid = ref.final_hidden(cell.params, port, pattern, wave,
                                   stats=stats)[at]
            picks = []
            for m in modes:
                mh = ref.final_hidden(cell.params, port, pattern, wave,
                                      quant=m)[at]
                picks.append(ref.head_logits(cell.params, mh,
                                             quant=m)["argmax"])
                del mh
            got = ref.head_logits(cell.params, hid, reads=[
                torch.tensor(served, device=device)] + picks)
        gaps += (got["best"] - got["reads"][0]).tolist()
        for m, read in zip(modes, got["reads"][1:]):
            mode_gaps[m] += (got["best"] - read).tolist()
        poison["reference"] += stats.get("poison", 0)
        poison["program"] += w.poison
        if device.type == "cuda":
            torch.cuda.empty_cache()
    exact = {"failed_requests": {"value": failed, "limit": 0},
             "tokens_mismatched": {"value": mismatch, "limit": 0}}
    verdict = held(gaps, limits, exact)
    # a mode stands in the program's place: its tokens are the ones it
    # puts first, judged by the same numbers and limits
    verdict["modes"] = {m: held(g, limits, {}) for m, g in mode_gaps.items()}
    log(f"judge: {len(picked)} waves, {len(gaps)} served tokens against "
        f"the reference in {time.perf_counter() - t0:.1f} s; gaps "
        + ", ".join(f"{k} {v:.6g}" for k, v in gap_readings(gaps).items())
        + "".join(f"; {m} {'correct' if v['correct'] else 'NOT correct'} "
                  + ", ".join(f"{k} {c['value']:.6g}"
                              for k, c in v["checks"].items())
                  for m, v in verdict["modes"].items())
        + "; poisoned dispatch "
        f"requests in those waves: program {poison['program']} (every "
        f"step), reference {poison['reference']} (the steps it follows)")
    verdict.update(gaps=gaps, first=first, mode_gaps=mode_gaps,
                   poison=poison)
    return verdict


def held(gaps: Sequence[float], limits: Dict, exact: Dict) -> Dict:
    """The configuration's gap checks (each of ``limits`` that
    :func:`gap_readings` reads) over ``gaps``, with the ``exact`` checks
    beside them, and whether every one holds."""
    readings = gap_readings(gaps)
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in limits.items() if name in readings}
    checks.update(exact)
    return {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()), "checks": checks}
