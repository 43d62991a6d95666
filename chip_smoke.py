"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with
``nvcc`` (into ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card (the two speculative kernels by both routes:
the tensor entries and the staged ones, whose indices, values and rows
sit in page-locked, mapped host slots), runs every workload of
``repro_torch.bench_irregular`` through ``repro_torch.codegen.run`` on the
card and checks it bit for bit against the port's sequential interpreter,
then runs the full-size codegen path (hist over 2**20 elements, spmv and
sort at n=1024), times it, and checks that every launch took the staged
route and that the only copies were the table's upload and download.
The ``[epoch]`` lines replay hist's first 512 epochs through the
pageable route (the tensor entries behind pageable copies, as the
drivers called them before the staged route) and the staged route in turns,
beside the latency floor of a launch and its wait, and time mapped
against pinned-copy gathers of 2-16 KB.  The kernel API's path follows: the
grouped GEMM and the two attention kernels against their plain versions
over an edge sweep in float32 and bfloat16, each call checked to take
the route its wrapper documents (the TMA kernels for aligned bf16, the
tiled kernels otherwise), then each once through
``repro_torch.kernels.ops`` at full model width (Kimi-K2's expert FFN,
Mistral-NeMo-12B's prefill and decode), checked against its plain version
and timed, the tiled bf16 GEMM and flash kernels beside the TMA ones.
The serving path follows (``[serve]`` lines): the engine on the card
against the same engine on the CPU at a small float32 size, the bf16
entries of the two speculative kernels over an edge sweep, then
Kimi-K2 at full width with one layer group (38.8 GB of bf16 weights
drawn on the card) serving 8 requests through
``repro_torch.serve.engine.Engine`` with ``dispatch="spec-kernel"``,
checked to launch each bf16 entry once per MoE forward and to commit
the tokens and poison counts of ``dispatch="spec"``, profiled for the
device's busy and idle time, its router's top-k (a stable sort, so ties
keep the reference's order) timed beside ``torch.topk``, and the two
bf16 entries held against
their plain versions at the prefill and decode shapes and timed.
After the parity phase, the ``[sim]`` lines run the paper's evaluation
path: each workload at its default size through
``repro_torch.core.pipeline.run_all`` (STA, DAE, SPEC and ORACLE cycles
of the model machine, not times on any chip), its SPEC pair through the
card, whose final memory must equal the simulated SPEC variant's bit for
bit; pagerank and join compiled cold and warm through the frontend's
compile cache with ``verify=True``, the warm objects run on the card
bitwise; and the soundness verifier's sweeps with mutants, in-process.
Phases print as they finish; the last lines are one
``{"kernels": [...]}`` JSON object, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line is printed.  Without a CUDA device, or outside a checkout, it
exits non-zero at once.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), for the byte bound
HBM_BYTES_PER_S = 3.35e12
#: float32 scatter-add tolerance (tests/test_kernels.py's atol, rtol=0):
#: atomics sum duplicates in run-dependent order, so the last bits may
#: differ from the plain version's sum
F32_ATOL = 1e-4
#: H100 SXM dense bfloat16 tensor-core rate (NVIDIA data sheet), for the
#: operation bound
BF16_FLOP_PER_S = 989e12
#: float32 tolerances of tests/test_kernels.py (rtol = atol)
GEMM_TOL, ATTN_TOL = 1e-3, 2e-3
#: bfloat16: another summation order, p and the output rounded to bf16
#: (GEMM: rtol, and atol as a share of max|want|)
BF16_ATTN_TOL, BF16_GEMM_RTOL = 2e-2, 1e-2
#: seconds each timing of the full-width phase aims at
TIMING_S = 1.0

FULL = {  # the main path at full size: cu_mode="vector", 2e8 AGU steps
    "hist": dict(n=1 << 20, n_bins=1 << 16),
    "spmv": dict(n=1024),
    "sort": dict(n=1024),
}
MAX_STEPS = 200_000_000


def fail(msg: str) -> None:
    """Stop the run with a non-zero exit and ``msg``."""
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 200) -> float:
    """Mean time of one eager ``fn()`` call in ms, CUDA events around
    ``reps`` back-to-back calls: at the main path's sizes this is the
    host's issue rate (Python, checks, launch), not the device's time."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = 200, replays: int = 5) -> float:
    """Mean device time of one ``fn()`` in ms: ``reps`` calls captured in
    one CUDA graph, CUDA events around ``replays`` replays, so no host
    work sits between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _sass_counts(path) -> dict:
    """Tensor-core and TMA instructions in a built library's SASS, or {}
    without ``cuobjdump``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {op: sass.count(op) for op in ("HGMMA", "HMMA", "UTMALDG")}


def phase_build() -> None:
    """Build every kernel in parallel and report the compiler's view:
    registers and spills (``-Xptxas -v``) of each kernel, any compiler
    warning, and the tensor-core and TMA instructions that shipped."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    secs = time.perf_counter() - t0
    print(f"[build] nvcc sm_90a, {len(build.SIGNATURES)} sources in "
          f"{secs:.2f} s -> {build.BUILD_DIR}")
    for name, log in sorted(build.BUILD_LOG.items()):
        fn = ""
        for line in log.strip().splitlines():
            line = line.strip()
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else ""
            elif "Used" in line and "registers" in line:
                print(f"[build] {name}: {line} ({fn[-60:]})")
            elif "spill" in line and " 0 bytes spill stores" not in line:
                print(f"[build] {name}: {line} ({fn[-60:]})")
            elif "warning" in line.lower():
                print(f"[build] {name}: {line}")
    for name in sorted(build.SIGNATURES):
        counts = _sass_counts(build.library_path(name))
        if counts:
            print(f"[build] {name} SASS: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
    print(f"[build] card: {smi()}")


def phase_kernels() -> None:
    """Both kernels against their plain versions over a shape sweep, by
    both routes: the tensor entries and the staged ones (indices, values
    and rows in page-locked, mapped host slots)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spec_gather import (spec_gather,
                                                 spec_gather_staged)
    from repro_torch.kernels.spec_scatter import (spec_scatter_add,
                                                  spec_scatter_add_staged)
    from repro_torch.kernels.staging import Ring
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cases = staged = 0
    ring = Ring(dev, slots=2)
    for dtype in (torch.int32, torch.float32):
        for d in (1, 7, 128):
            for n, kind in ((0, "mixed"), (1, "mixed"), (5, "mixed"),
                            (8, "mixed"), (37, "mixed"), (512, "mixed"),
                            (4099, "mixed"), (6, "poison"),
                            (4096, "poison"), (23, "dups"),
                            (4099, "dups")):
                rows = 61
                # -1 poison, in-range rows, and rows past the end (clip);
                # every request poisoned; few destinations, many requests
                idx_np = rng.integers(-1, rows + 6, n).astype(np.int32)
                if kind == "poison":
                    idx_np[:] = -1
                elif kind == "dups":
                    idx_np = rng.integers(-1, 3, n).astype(np.int32)
                if dtype == torch.int32:
                    tab_np = rng.integers(-2 ** 31, 2 ** 31, (rows, d),
                                          dtype=np.int64).astype(np.int32)
                    val_np = rng.integers(-2 ** 31, 2 ** 31, (n, d),
                                          dtype=np.int64).astype(np.int32)
                else:
                    tab_np = rng.standard_normal((rows, d)).astype(np.float32)
                    val_np = rng.standard_normal((n, d)).astype(np.float32)
                    if kind == "dups":
                        # small integers: a float32 sum of thousands of
                        # duplicates is then exact in any order
                        tab_np = np.round(tab_np * 8)
                        val_np = np.round(val_np * 8)
                tab = torch.from_numpy(tab_np).to(dev)
                idx = torch.from_numpy(idx_np).to(dev)
                val = torch.from_numpy(val_np).to(dev)
                got = spec_gather(tab, idx)
                torch.cuda.synchronize()
                if not torch.equal(got, ref.spec_gather(tab, idx)):
                    fail(f"spec_gather {dtype} n={n} d={d} differs")
                got = spec_scatter_add(tab.clone(), idx, val)
                torch.cuda.synchronize()
                want = ref.spec_scatter_add(tab.clone(), idx, val)
                if dtype == torch.int32:
                    ok = torch.equal(got, want)
                else:
                    ok = torch.allclose(got, want, rtol=0, atol=F32_ATOL)
                if not ok:
                    fail(f"spec_scatter_add {dtype} n={n} d={d} differs")
                cases += 1
                if dtype != torch.int32 or d != 1:
                    continue
                # the staged route (the drivers' int32 rows of one
                # element) on the same inputs: the values are on the host
                # when the gather returns, with no synchronize
                slot = ring.acquire(n)
                slot.idx[:n] = idx_np
                slot.val[:n] = val_np[:, 0]
                got = spec_gather_staged(tab, slot, n)
                if not np.array_equal(got, ref.spec_gather(tab, idx)[:, 0]
                                      .cpu().numpy()):
                    fail(f"spec_gather_staged n={n} {kind} differs")
                got = spec_scatter_add_staged(tab.clone(), slot, n)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"spec_scatter_add_staged n={n} {kind} differs")
                staged += 1
    ring.drain()
    print(f"[kernels] {cases} cases x 2 kernels by the tensor route and "
          f"{staged} int32 one-element-row cases by the staged route agree "
          f"with the plain versions (n off a multiple of 4, n = 0, every "
          f"request poisoned, clip, duplicates; int32 bitwise, gather "
          f"float32 bitwise, scatter float32 rtol=0 atol={F32_ATOL})")


def _counters():
    from repro_torch.kernels.spec_gather import spec_gather
    from repro_torch.kernels.spec_scatter import spec_scatter_add
    return spec_gather, spec_scatter_add


def _reset() -> None:
    for c in _counters():
        c.launches = 0
        c.route_launches = dict.fromkeys(c.route_launches, 0)
        c.entry_launches = dict.fromkeys(c.entry_launches, 0)


def _launches():
    g, s = _counters()
    return g.launches, s.launches


def _routes():
    """Launches by route of both kernels since the last :func:`_reset`."""
    g, s = _counters()
    return dict(g.route_launches), dict(s.route_launches)


def _only_staged(tag: str, g: int, s: int) -> None:
    """Fail unless every launch since the last reset took the staged
    route."""
    want = ({"tensor": 0, "staged": g}, {"tensor": 0, "staged": s})
    if _routes() != want:
        fail(f"{tag}: launches by route {_routes()}, want {want}")


def phase_parity() -> None:
    """Every workload x compiler x CU mode on the card, bit-exact."""
    from repro_torch import codegen
    from repro_torch.bench_irregular import ALL
    from repro_torch.core import interp, pipeline
    t0 = time.perf_counter()
    legs = 0
    for name in sorted(ALL):
        case = ALL[name]()
        ref = {k: v.copy() for k, v in case.memory.items()}
        interp.run(case.fn, ref, case.params)
        for pname in ("dae", "spec"):
            comp = getattr(pipeline, f"compile_{pname}")(case.fn,
                                                         case.decoupled)
            for cu_mode in ("vector", "state-machine"):
                runs = {}
                for device in ("cpu", "cuda"):
                    mem = {k: v.copy() for k, v in case.memory.items()}
                    _reset()
                    r = codegen.run(comp, mem, case.params, target="torch",
                                    device=device, cu_mode=cu_mode)
                    torch.cuda.synchronize()
                    runs[device] = (r, _launches())
                    for k in ref:
                        if not np.array_equal(ref[k], mem[k]):
                            fail(f"{name}/{pname}/{cu_mode}/{device}: "
                                 f"array {k} differs from the interpreter")
                (rc, (g, s)), (rp, _) = runs["cuda"], runs["cpu"]
                tag = f"{name}/{pname}/{cu_mode}"
                for key in ("target_used", "cu_mode", "vector_reason",
                            "forward_reason", "fallback_reason"):
                    if getattr(rc, key) != getattr(rp, key):
                        fail(f"{tag}: {key} differs cuda/cpu")
                if rc.stats != rp.stats:
                    fail(f"{tag}: stats differ cuda/cpu: {rc.stats} vs "
                         f"{rp.stats}")
                want = (rc.stats.get("gather_calls", 0),
                        rc.stats.get("scatter_calls", 0))
                if (g, s) != want:
                    fail(f"{tag}: launches {(g, s)} != calls {want}")
                _only_staged(tag, g, s)
                if pname == "spec" and not (g > 0 and s > 0):
                    fail(f"{tag}: the kernels were not launched")
                legs += 1
    print(f"[parity] {legs} legs (11 workloads x dae/spec x vector/"
          f"state-machine) bit-exact on cuda, stats equal to the cpu run, "
          f"launch counts equal to gather/scatter calls, all by the staged "
          f"route "
          f"({time.perf_counter() - t0:.1f} s)")


def _sim_against_card(card: str) -> None:
    """Each workload at its ``build`` defaults through ``run_all`` (the
    model machine's cycles) and its SPEC pair through the card."""
    from repro_torch import codegen
    from repro_torch.bench_irregular import ALL
    from repro_torch.core import pipeline
    for name in sorted(ALL):
        case = ALL[name]()
        t0 = time.perf_counter()
        runs = pipeline.run_all(case.fn, case.decoupled, case.memory,
                                params=case.params)
        sim_s = time.perf_counter() - t0
        ref = runs["ref"].memory
        for v in ("sta", "dae", "spec"):
            for k in ref:
                if not np.array_equal(runs[v].memory[k], ref[k]):
                    fail(f"[sim] {name}/{v}: array {k} differs from the "
                         f"sequential interpreter")
        spec = runs["spec"]
        comp = spec.compiled
        mem = {k: v.copy() for k, v in case.memory.items()}
        _reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = codegen.run(comp, mem, case.params, target="torch",
                        device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        g, s = _launches()
        for k in spec.memory:
            if not (mem[k].dtype == spec.memory[k].dtype
                    and np.array_equal(mem[k], spec.memory[k])):
                fail(f"[sim] {name}: the card's array {k} differs from the "
                     f"simulated spec variant's")
        if r.target_used != "torch" or r.fell_back:
            fail(f"[sim] {name}: the card run fell back "
                 f"({r.fallback_reason})")
        want = (r.stats.get("gather_calls", 0), r.stats.get("scatter_calls", 0))
        if (g, s) != want or not g:
            fail(f"[sim] {name}: launches {(g, s)} != calls {want}")
        _only_staged(f"[sim] {name}", g, s)
        cyc = {v: runs[v].cycles for v in ("sta", "dae", "spec", "oracle")}
        print(f"[sim] {name}: model-machine cycles sta {cyc['sta']} dae "
              f"{cyc['dae']} spec {cyc['spec']} oracle {cyc['oracle']}, "
              f"spec/sta speedup {cyc['sta'] / cyc['spec']:.2f}, misspec "
              f"{spec.result.misspec_rate:.3f}, poison blocks "
              f"{comp.poison_stats.poison_blocks} calls "
              f"{comp.poison_stats.poison_calls}; simulator {sim_s:.3f} s "
              f"host; card run {wall_ms:.1f} ms wall, {g} gathers + {s} "
              f"scatters, {r.cu_mode}, memory = simulated spec bitwise "
              f"({card})")


def _cache_on_card(card: str) -> None:
    """pagerank and join through the frontend's compile cache: one cold
    and one warm compile each, the warm object run on the card."""
    import shutil
    import tempfile
    from repro_torch import codegen
    from repro_torch.bench_irregular import ALL, join, pagerank
    from repro_torch.core import interp
    from repro_torch.frontend import CompileCache
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="compile_cache.",
                            dir=os.path.join(ROOT, "build"))
    try:
        cc = CompileCache(root)
        for name, factory in (("pagerank", pagerank.program),
                              ("join", join.program)):
            case = ALL[name]()
            ms = {}
            for want in ("cold", "warm"):
                t0 = time.perf_counter()
                comp = factory().compile(case.decoupled, cache=cc,
                                         verify=True)
                ms[want] = (time.perf_counter() - t0) * 1e3
                if comp.cache_stats["outcome"] != want:
                    fail(f"[sim] cache {name}: outcome "
                         f"{comp.cache_stats['outcome']}, want {want}")
            ref = {k: v.copy() for k, v in case.memory.items()}
            interp.run(case.fn, ref, case.params)
            for cu_mode in ("vector", "state-machine"):
                mem = {k: v.copy() for k, v in case.memory.items()}
                _reset()
                r = codegen.run(comp, mem, case.params, target="torch",
                                device="cuda", cu_mode=cu_mode)
                torch.cuda.synchronize()
                g, s = _launches()
                if r.cache["outcome"] != "warm" or r.cu_mode != cu_mode:
                    fail(f"[sim] cache {name}/{cu_mode}: {r.cache} "
                         f"{r.cu_mode}")
                if not g:
                    fail(f"[sim] cache {name}/{cu_mode}: no launch")
                _only_staged(f"[sim] cache {name}/{cu_mode}", g, s)
                for k in ref:
                    if not np.array_equal(ref[k], mem[k]):
                        fail(f"[sim] cache {name}/{cu_mode}: array {k} "
                             f"differs from the interpreter")
            print(f"[sim] cache {name}: cold compile {ms['cold']:.2f} ms, "
                  f"warm {ms['warm']:.2f} ms (host, verify=True); warm "
                  f"object bitwise on the card, vector and state-machine "
                  f"({card})")
        if (cc.misses, cc.hits, cc.stale) != (2, 2, 0):
            fail(f"[sim] cache: misses/hits/stale {cc.misses}/{cc.hits}/"
                 f"{cc.stale}, want 2/2/0")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _verifier() -> None:
    """``python -m repro_torch.verify``'s sweeps, in-process."""
    import contextlib
    import io
    from repro_torch.verify.__main__ import main as verify_main
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = verify_main(["--all", "--mutants", "--randprog", "8",
                          "--negative", "4"])
    secs = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    if rc != 0:
        fail("[sim] verifier: " + " | ".join(lines[-8:]))
    clean = sum(line.startswith("ok   workload/") for line in lines)
    mutants = caught = 0
    for line in lines:
        parts = line.split()
        if len(parts) == 4 and parts[1] == "mutants,":
            mutants += int(parts[0])
            caught += int(parts[2])
    if clean != 11 or caught != mutants or not mutants:
        fail(f"[sim] verifier: {clean} clean workloads, {caught} of "
             f"{mutants} mutants caught")
    print(f"[sim] verifier: exit 0, {clean} workloads clean, {caught} of "
          f"{mutants} mutants caught, {lines[-3].strip()}; "
          f"{lines[-2].strip()}; {lines[-1].strip()} ({secs:.2f} s host)")


def phase_sim() -> None:
    """The paper's evaluation path on the port: the cycle simulator
    against the card, the compile cache, the soundness verifier."""
    t0 = time.perf_counter()
    card = smi()
    _sim_against_card(card)
    _cache_on_card(card)
    _verifier()
    print(f"[sim] phase {time.perf_counter() - t0:.1f} s")


#: hist epochs whose kernel inputs the census records for the [epoch] A/B
EPOCH_REPLAY = 512


def _census(shapes, args, seq=None):
    """Wrap the drivers' staged kernel entries to record launch shapes,
    one argument set per shape, and, into ``seq`` when given, the table
    at the first call and every call's inputs of the first
    :data:`EPOCH_REPLAY` epochs (a gather and a scatter each).  Returns
    the restoring function and the count of table clones the census
    made (device-to-device copies)."""
    from repro_torch.codegen import torch_backend, vector
    from repro_torch.kernels.spec_gather import spec_gather_staged as g0
    from repro_torch.kernels.spec_scatter import (
        spec_scatter_add_staged as s0)
    count = collections.Counter()

    def record(name, table, slot, n):
        key = (name, table.shape[0], n, table.shape[1])
        shapes[key] += 1
        idx = slot.idx[:n].copy()
        val = slot.val[:n].copy() if name == "spec_scatter_add" else None
        if key not in args:
            args[key] = (table.clone(), idx, val)
            count["clones"] += 1
        if seq is not None and count[name] < EPOCH_REPLAY:
            if not seq:
                seq.append(table.clone())
                count["clones"] += 1
            seq.append((name, idx, val))
        count[name] += 1

    def g(table, slot, n):
        record("spec_gather", table, slot, n)
        return g0(table, slot, n)

    def s(table, slot, n):
        record("spec_scatter_add", table, slot, n)
        return s0(table, slot, n)

    saved = (vector.spec_gather_staged, vector.spec_scatter_add_staged,
             torch_backend.spec_gather_staged,
             torch_backend.spec_scatter_add_staged)
    vector.spec_gather_staged = torch_backend.spec_gather_staged = g
    vector.spec_scatter_add_staged = torch_backend.spec_scatter_add_staged = s

    def restore():
        (vector.spec_gather_staged, vector.spec_scatter_add_staged,
         torch_backend.spec_gather_staged,
         torch_backend.spec_scatter_add_staged) = saved
    return restore, count


def phase_full():
    """The main path at full size; returns launches, device ms of each
    kernel, the launch shapes with one argument set each, and the
    recorded first epochs of hist."""
    from repro_torch import codegen
    from repro_torch.bench_irregular import ALL
    from repro_torch.codegen.emit import compile_mode
    from repro_torch.core import interp, pipeline
    totals = [0, 0]
    kernel_ms = [0.0, 0.0]
    shapes: collections.Counter = collections.Counter()
    args: dict = {}
    seq: list = []
    for name, kw in FULL.items():
        case = ALL[name](**kw)
        comp = pipeline.compile_spec(case.fn, case.decoupled)
        ref = {k: v.copy() for k, v in case.memory.items()}
        t0 = time.perf_counter()
        interp.run(case.fn, ref, case.params, max_steps=MAX_STEPS)
        t_interp = time.perf_counter() - t0

        mem = {k: v.copy() for k, v in case.memory.items()}
        _reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = codegen.run(comp, mem, case.params, target="torch",
                        cu_mode="vector", max_steps=MAX_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g, s = _launches()
        for k in ref:
            if not np.array_equal(ref[k], mem[k]):
                fail(f"full {name}: array {k} differs from the interpreter")
        if r.target_used != "torch" or r.cu_mode != "vector":
            fail(f"full {name}: ran {r.target_used}/{r.cu_mode}: "
                 f"{r.fallback_reason or r.vector_reason}")
        if (g, s) != (r.stats["gather_calls"], r.stats["scatter_calls"]):
            fail(f"full {name}: launches {(g, s)} != calls "
                 f"{(r.stats['gather_calls'], r.stats['scatter_calls'])}")
        if not (g > 0 and s > 0):
            fail(f"full {name}: the kernels were not launched")
        _only_staged(f"full {name}", g, s)
        totals[0] += g
        totals[1] += s

        # the AGU slice alone (host, ahead of the CU), for the breakdown
        agu = compile_mode(comp.agu, "agu-stream")
        t0 = time.perf_counter()
        agu({k: v.copy() for k, v in case.memory.items()},
            dict(case.params), MAX_STEPS)
        t_agu = time.perf_counter() - t0

        # second, profiled run: device time by kernel and copy, and the
        # census of launch shapes (these launches are not counted above)
        mem2 = {k: v.copy() for k, v in case.memory.items()}
        restore, census = _census(shapes, args,
                                  seq if name == "hist" else None)
        try:
            act = [torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=act) as prof:
                codegen.run(comp, mem2, case.params, target="torch",
                            cu_mode="vector", max_steps=MAX_STEPS)
                torch.cuda.synchronize()
        finally:
            restore()
        for k in ref:
            if not np.array_equal(ref[k], mem2[k]):
                fail(f"full {name} (profiled): array {k} differs")
        # device time by kernel; the staged route's kernels only (the
        # tensor route's are spec_gather_kernel / spec_scatter_add_kernel)
        parts = ("spec_gather_staged_kernel", "spec_scatter_add_staged_kernel",
                 "spec_gather_kernel", "spec_scatter_add_kernel")
        dev_us = collections.Counter()
        copies = collections.Counter()
        copy_us = 0.0
        copy_ops = 0
        for ev in prof.key_averages():
            for part in parts:
                if part in ev.key:
                    dev_us[part] += ev.self_device_time_total
            if ev.key.startswith("Memcpy"):
                kind = ev.key.split()[1]
                copies[kind] += ev.count
                if kind != "DtoD":
                    copy_us += ev.self_device_time_total
            elif ev.key == "aten::copy_":
                copy_ops += ev.count
        for part in parts[:2]:
            if not dev_us[part]:
                fail(f"full {name}: the profiler saw no {part} device time")
        for part in parts[2:]:
            if dev_us[part]:
                fail(f"full {name}: the tensor route's {part} ran")
        # the only copies the run makes: the table's upload at the start
        # and its download at the end, none per epoch, besides the
        # census's own table clones (device to device).  Counted as
        # PyTorch copy ops, which the profiler records on the host for
        # certain; on the device timeline a small upload can go
        # unrecorded, so there each direction is held to at most one.
        if copy_ops != 2 + census["clones"]:
            fail(f"full {name}: {copy_ops} copy ops, want 2 (the table's "
                 f"upload and download) + {census['clones']} census clones")
        if copies["HtoD"] > 1 or copies["DtoH"] > 1:
            fail(f"full {name}: device copies {dict(copies)}, want at most "
                 f"one HtoD (the table's upload) and one DtoH (its "
                 f"download)")
        gk = dev_us["spec_gather_staged_kernel"] / 1e3
        sk = dev_us["spec_scatter_add_staged_kernel"] / 1e3
        cp = copy_us / 1e3
        kernel_ms[0] += gk
        kernel_ms[1] += sk
        host = wall * 1e3 - t_agu * 1e3 - gk - sk - cp
        print(f"[full] {name} {kw}: bit-exact; epochs={r.stats['epochs']} "
              f"launches gather={g} scatter={s}, all staged; wall="
              f"{wall * 1e3:.1f} ms = AGU streams {t_agu * 1e3:.1f} ms (host) "
              f"+ gather kernel {gk:.3f} ms + scatter kernel {sk:.3f} ms + "
              f"table upload and download {cp:.3f} ms (device, profiler; "
              f"{copy_ops - census['clones']} copy ops) + CU host, launch "
              f"and wait "
              f"{host:.1f} ms; per launch gather {gk / g * 1e3:.2f} us, "
              f"scatter {sk / s * 1e3:.2f} us; interpreter "
              f"{t_interp * 1e3:.1f} ms")
    return totals, kernel_ms, shapes, args, seq


def _us(ts) -> dict:
    """Mean and median of per-call host seconds, in microseconds."""
    a = np.asarray(ts) * 1e6
    return {"mean": float(a.mean()), "p50": float(np.median(a)),
            "calls": int(a.size)}


def _floor_call(mapped):
    """One latency-floor call: an empty kernel (``mapped`` None), or one
    4-byte read and write of mapped host memory, launched and waited for
    through the staged route's ctypes path."""
    from repro_torch.kernels import build
    fn = build.load("spec_gather").spec_staging_floor
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    return lambda: build.check(fn(mapped, stream, dev), "spec_staging_floor")


def phase_epoch(seq) -> dict:
    """The epoch round trip on hist's own first epochs, old route against
    new in turns (old, new, new, old), each turn a pass without and a
    pass with a stream sync after each scatter; the latency floor; and
    mapped against pinned-copy gathers at 2-16 KB requests."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.spec_gather import (spec_gather,
                                                 spec_gather_staged)
    from repro_torch.kernels.spec_scatter import (spec_scatter_add,
                                                  spec_scatter_add_staged)
    from repro_torch.kernels.staging import Ring
    dev = torch.device("cuda")
    table0, calls = seq[0], seq[1:]
    counters = _counters()
    saved = [(c.launches, dict(c.route_launches)) for c in counters]
    sync = torch.cuda.current_stream().synchronize

    # what every route must give: the plain versions' replay
    t = table0.clone()
    want = []
    for name, idx, val in calls:
        ti = torch.from_numpy(idx).to(dev)
        if name == "spec_gather":
            want.append(ref.spec_gather(t, ti)[:, 0].cpu().numpy())
        else:
            ref.spec_scatter_add(t, ti,
                                 torch.from_numpy(val).to(dev)[:, None])
    want_table = t

    def old(t, g_us, s_us, synced):
        """The drivers' code before the staged route: pad with poison to a
        power of two of at least 8, pageable copies, the tensor entries, a
        read-back through ``.cpu()``."""
        got = []
        for name, idx, val in calls:
            n = len(idx)
            b = max(8, 1 << (n - 1).bit_length())
            t0 = time.perf_counter()
            if name == "spec_gather":
                pad = np.full(b, -1, np.int32)
                pad[:n] = idx
                v = spec_gather(t, torch.from_numpy(pad).to(dev))
                got.append(v[:n, 0].cpu().numpy())
                g_us.append(time.perf_counter() - t0)
                continue
            ip = np.full(b, -1, np.int32)
            ip[:n] = idx
            dp = np.zeros((b, 1), np.int32)
            dp[:n, 0] = val
            spec_scatter_add(t, torch.from_numpy(ip).to(dev),
                             torch.from_numpy(dp).to(dev))
            if synced:
                sync()
            s_us.append(time.perf_counter() - t0)
        return got

    ring = Ring(dev)

    def new(t, g_us, s_us, synced):
        """The staged route, as the drivers call it."""
        got = []
        for name, idx, val in calls:
            n = len(idx)
            t0 = time.perf_counter()
            slot = ring.acquire(n)
            slot.idx[:n] = idx
            if name == "spec_gather":
                got.append(spec_gather_staged(t, slot, n).copy())
                g_us.append(time.perf_counter() - t0)
                continue
            slot.val[:n] = val
            spec_scatter_add_staged(t, slot, n)
            if synced:
                sync()
            s_us.append(time.perf_counter() - t0)
        return got

    times = {r: collections.defaultdict(list) for r in ("old", "new")}
    for route in ("old", "new", "new", "old"):
        for synced in (False, True):
            t = table0.clone()
            torch.cuda.synchronize()
            tm = times[route]
            got = (old if route == "old" else new)(
                t, tm["gather"] if not synced else [],
                tm["scatter_sync" if synced else "scatter_issue"], synced)
            torch.cuda.synchronize()
            if not torch.equal(t, want_table) or not all(
                    np.array_equal(a, b) for a, b in zip(got, want)):
                fail(f"epoch replay: the {route} route's rows or table "
                     f"differ from the plain versions'")
    rows = {r: {k: _us(v) for k, v in tm.items()} for r, tm in times.items()}

    # the latency floor, in turns
    slot = ring.acquire(4)
    floor = collections.defaultdict(list)
    for kind in ("empty", "mapped", "mapped", "empty"):
        call = _floor_call(slot.idx_ptr if kind == "mapped" else None)
        for _ in range(50):
            call()
        for _ in range(1000):
            t0 = time.perf_counter()
            call()
            floor[kind].append(time.perf_counter() - t0)
    floor = {k: _us(v) for k, v in floor.items()}

    # mapped against pinned cudaMemcpyAsync for 2-16 KB requests, one C
    # call each: indices from and rows to the same page-locked slot
    lib = build.load("spec_gather")
    stream = torch.cuda.current_stream().cuda_stream
    index = torch.cuda.current_device()
    rng = np.random.default_rng(14)
    rows_n = table0.shape[0]
    sweep = {}
    for n in (512, 1024, 2048, 4096):
        idx = rng.integers(-1, rows_n, n).astype(np.int32)
        want_n = ref.spec_gather(table0, torch.from_numpy(idx).to(dev))
        want_n = want_n[:, 0].cpu().numpy()
        dev_idx = torch.empty(n, dtype=torch.int32, device=dev)
        dev_out = torch.empty(n, dtype=torch.int32, device=dev)
        ts = collections.defaultdict(list)
        for kind in ("mapped", "copied", "copied", "mapped"):
            for rep in range(550):
                t0 = time.perf_counter()
                slot = ring.acquire(n)
                slot.idx[:n] = idx
                if kind == "mapped":
                    got = spec_gather_staged(table0, slot, n).copy()
                else:
                    build.check(lib.spec_gather_copied_i32(
                        table0.data_ptr(), slot.idx.ctypes.data,
                        slot.out.ctypes.data, dev_idx.data_ptr(),
                        dev_out.data_ptr(), rows_n, n, stream, index),
                        "spec_gather_copied_i32")
                    got = slot.out[:n].copy()
                if rep >= 50:
                    ts[kind].append(time.perf_counter() - t0)
            if not np.array_equal(got, want_n):
                fail(f"epoch sweep: the {kind} gather of {n} rows differs")
        sweep[n] = {k: _us(v) for k, v in ts.items()}
    ring.drain()
    for c, (launches, by_route) in zip(counters, saved):
        c.launches, c.route_launches = launches, by_route

    n_g = sum(1 for c in calls if c[0] == "spec_gather")
    sizes = [len(c[1]) for c in calls]
    print(f"[epoch] hist's first {n_g} epochs replayed ({len(calls)} calls, "
          f"{min(sizes)}-{max(sizes)} requests a call), host clock per "
          f"call in turns old, new, new, old; bit-exact against the plain "
          f"versions every turn")
    for route, what in (("old", "pageable route: pad, pageable H2D copies, "
                                "tensor entries, .cpu() read-back"),
                        ("new", "staged route: page-locked mapped slot, one "
                                "C call")):
        r = rows[route]
        print(f"[epoch] {route} ({what}): gather round trip mean "
              f"{r['gather']['mean']:.2f} us (p50 {r['gather']['p50']:.2f}); "
              f"scatter issue {r['scatter_issue']['mean']:.2f} us (p50 "
              f"{r['scatter_issue']['p50']:.2f}); scatter + stream sync "
              f"{r['scatter_sync']['mean']:.2f} us (p50 "
              f"{r['scatter_sync']['p50']:.2f})")
    print(f"[epoch] latency floor (launch + wait through the same ctypes "
          f"path): empty kernel {floor['empty']['mean']:.2f} us (p50 "
          f"{floor['empty']['p50']:.2f}); one 4-byte mapped read and write "
          f"{floor['mapped']['mean']:.2f} us (p50 "
          f"{floor['mapped']['p50']:.2f})")
    for n, r in sweep.items():
        print(f"[epoch] gather round trip at {n} rows ({4 * n} B): mapped "
              f"{r['mapped']['mean']:.2f} us (p50 {r['mapped']['p50']:.2f}), "
              f"pinned cudaMemcpyAsync {r['copied']['mean']:.2f} us (p50 "
              f"{r['copied']['p50']:.2f})")
    return {"replay": rows, "floor": floor,
            "mapped_vs_copied": {str(n): r for n, r in sweep.items()},
            "epochs": n_g}


def phase_line(totals, kernel_ms, shapes, args, seq) -> dict:
    """Each kernel at the main path's most frequent launch shape: the
    staged kernel (the main path's) and the tensor entry's kernel by
    CUDA-graph replay, against the plain version, one library call and
    the byte bound; then the epoch A/B of :func:`phase_epoch`."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.spec_gather import (spec_gather,
                                                 spec_gather_staged)
    from repro_torch.kernels.spec_scatter import (spec_scatter_add,
                                                  spec_scatter_add_staged)
    from repro_torch.kernels.staging import Ring
    epoch = phase_epoch(seq)
    dev = torch.device("cuda")
    index = torch.cuda.current_device()
    out = []
    for i, (name, lib, src, replaces) in enumerate((
            ("spec_gather", "spec_gather",
             "src/repro_torch/kernels/csrc/spec_gather.cu",
             "src/repro/kernels/spec_gather.py:114"),
            ("spec_scatter_add", "spec_scatter",
             "src/repro_torch/kernels/csrc/spec_scatter.cu",
             "src/repro/kernels/spec_scatter.py:124"))):
        key = max((k for k in shapes if k[0] == name), key=shapes.get)
        table, idx_np, val_np = args[key]
        rows, n, d = key[1], key[2], key[3]
        idx = torch.from_numpy(idx_np).to(dev)
        live = idx >= 0
        n_live = int(live.sum())
        safe = idx.clamp(0, rows - 1).long()
        ring = Ring(dev, slots=1)
        slot = ring.acquire(n)
        slot.idx[:n] = idx_np
        g0 = [(c.launches, dict(c.route_launches)) for c in _counters()]
        staged_fn = getattr(build.load(lib), f"{name}_staged_i32")
        if name == "spec_gather":
            got = torch.from_numpy(spec_gather_staged(table, slot, n).copy())
            want = ref.spec_gather(table, idx)[:, 0].cpu()
            # the staged kernel alone, without its wait, for graph capture
            kern = lambda: build.check(staged_fn(
                table.data_ptr(), slot.idx_ptr, slot.out_ptr, rows, n,
                torch.cuda.current_stream().cuda_stream, index, 0), name)
            tensor = lambda: spec_gather(table, idx)
            plain = lambda: ref.spec_gather(table, idx)
            lib_call = lambda: table.index_select(0, safe)
            # index read, live rows read, every output row written
            nbytes = 4 * n + 4 * d * n_live + 4 * d * n
        else:
            values = torch.from_numpy(val_np).to(dev)[:, None]
            slot.val[:n] = val_np
            got = spec_scatter_add_staged(table.clone(), slot, n).cpu()
            want = ref.spec_scatter_add(table.clone(), idx, values).cpu()
            t2 = table.clone()
            vmask = torch.where(live[:, None], values,
                                torch.zeros_like(values))
            kern = lambda: build.check(staged_fn(
                t2.data_ptr(), slot.idx_ptr, slot.val_ptr, rows, n,
                torch.cuda.current_stream().cuda_stream, None, index), name)
            tensor = lambda: spec_scatter_add(t2, idx, values)
            plain = lambda: ref.spec_scatter_add(t2, idx, values)
            lib_call = lambda: t2.index_add_(0, safe, vmask)
            uniq = int(torch.unique(safe[live]).numel())
            # index and live values read, each live destination row read
            # and written once
            nbytes = 4 * n + 4 * d * n_live + 2 * 4 * d * uniq
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() if n else 0.0
        if err != 0.0:
            fail(f"{name} at the main path's shape differs by {err}")
        ms, tensor_ms = device_ms(kern), device_ms(tensor)
        plain_ms, lib_ms = device_ms(plain), device_ms(lib_call)
        eager = call_ms(tensor)
        for c, (launches, by_route) in zip(_counters(), g0):
            c.launches, c.route_launches = launches, by_route
        ring.drain()
        floor = epoch["floor"]["empty"]["mean"]
        replay = {r: epoch["replay"][r]["gather" if i == 0 else
                                      "scatter_issue"]["mean"]
                  for r in ("old", "new")}
        print(f"[line] {name} rows={rows} n={n} d={d}: staged kernel "
              f"{ms * 1e3:.4f} us, tensor-entry kernel {tensor_ms * 1e3:.4f} "
              f"us (device, CUDA-graph replay); plain {plain_ms * 1e3:.4f} "
              f"us, library {lib_ms * 1e3:.4f} us; byte bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e9:.4f} us, latency floor "
              f"{floor:.2f} us (host); per call on hist's epochs: new "
              f"{replay['new']:.2f} us, old {replay['old']:.2f} us "
              f"({'round trip' if i == 0 else 'issue'})")
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": totals[i],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": lib_ms,
            "launch_route": "staged", "tensor_route_ms": tensor_ms,
            "tensor_route_call_ms": eager, "floor_ms": floor / 1e3,
            "epoch_call_us": replay, "main_path_kernel_ms": kernel_ms[i],
            "shape": {"rows": rows, "n": n, "d": d, "n_live": n_live,
                      "dtype": str(table.dtype).replace("torch.", ""),
                      "share_of_launches": shapes[key] / sum(
                          v for k, v in shapes.items() if k[0] == name)},
        })
    out[0]["epoch"] = epoch
    return {"kernels": out}

# ---------------------------------------------------------------------------
# the kernel API's path: grouped GEMM and attention
# ---------------------------------------------------------------------------


def round_capacity(n_tokens: int, n_experts: int, top_k: int,
                   factor: float, multiple: int = 8) -> int:
    """Expert capacity, a copy of ``repro.models.moe.round_capacity``."""
    cap = int(factor * n_tokens * top_k / n_experts) + 1
    return max(multiple, ((cap + multiple - 1) // multiple) * multiple)


def _dense_kernels():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ragged_matmul import ragged_matmul
    return ragged_matmul, flash_attention, paged_attention


def _close(got, want, dtype, gemm: bool) -> float:
    """Max abs error of ``got`` against ``want``; fails past tolerance."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{tuple(got.shape)} {got.dtype} != {tuple(want.shape)} "
             f"{want.dtype}")
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail("non-finite output")
    if dtype == torch.float32:
        rtol = atol = GEMM_TOL if gemm else ATTN_TOL
    elif gemm:
        rtol = BF16_GEMM_RTOL
        atol = BF16_GEMM_RTOL * max(want.abs().max().item(), 1e-6)
    else:
        rtol = atol = BF16_ATTN_TOL
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"max abs error {(got - want).abs().max().item()} past "
             f"rtol={rtol} atol={atol}")
    return (got - want).abs().max().item() if got.numel() else 0.0


def _paged_edges(rng, b, h, d, p, page, nmax):
    """Paged inputs with seq_len 0, -1 tail pages, a page id past the pool
    and a row whose pages are all -1 (numpy, float32)."""
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((p, page, h, d)).astype(np.float32)
    vp = rng.standard_normal((p, page, h, d)).astype(np.float32)
    pt = rng.integers(0, p, (b, nmax)).astype(np.int32)
    seq = rng.integers(1, page * nmax + 1, b).astype(np.int32)
    used = (seq + page - 1) // page
    for i in range(b):
        pt[i, used[i]:] = -1
    if b > 1:
        seq[0] = 0
        pt[1, 0] = p + 3
    if b > 2:
        pt[2] = -1
    return q, kp, vp, pt, seq


def phase_kernels_dense() -> None:
    """The grouped GEMM and both attention kernels against their plain
    versions over an edge sweep, float32 and bfloat16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ragged_matmul import plan as ragged_plan
    ragged, flash, paged = _dense_kernels()
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    worst = collections.defaultdict(float)
    cases = collections.Counter()

    def put(dtype, *arrays):
        return [torch.from_numpy(a).to(dev).to(dtype) for a in arrays]

    def routed(counter, want_route, call):
        """``call()``, failing unless it launched once, by ``want_route``."""
        before = dict(counter.route_launches)
        got = call()
        moved = {r: counter.route_launches[r] - before[r] for r in before}
        if moved != {r: int(r == want_route) for r in before}:
            fail(f"{counter.__name__}: launches by route {moved}, want one "
                 f"by {want_route}")
        routes[counter.__name__, want_route] += 1
        return got

    routes = collections.Counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        # capacity, F and D off the 64x128 (64x64) tiles and off the tma
        # route's 64-row, 64-K, 128/256-column stages; capacity 56 (the
        # full-width case) and 200 (four M tiles); D or F not a multiple
        # of 8 (the tma route's 16-byte strides), which stays on the tiled
        # kernel
        for e, c, d, f in ((4, 64, 128, 256), (3, 56, 96, 200),
                           (2, 13, 37, 45), (5, 70, 128, 136),
                           (3, 200, 264, 520), (2, 56, 100, 64),
                           (2, 24, 64, 70)):
            x, w = put(dtype, rng.standard_normal((e * c, d), np.float32),
                       rng.standard_normal((e, d, f), np.float32))
            route = ragged_plan(e, c, d, f, dtype, True, sms).route
            got = routed(ragged, route, lambda: ragged(x, w, capacity=c))
            err = _close(got, ref.ragged_matmul(x, w, c), dtype, gemm=True)
            worst["ragged_matmul", tag] = max(worst["ragged_matmul", tag],
                                              err)
            cases["ragged_matmul"] += 1
        # T off the 128-row query tile and key stage (and off the tiled kernel's 64 /
        # 32); tq < tk and tq > tk (dead causal rows exactly zero); d 64
        # and 128; B*H = 140, past the 132 SMs
        for b, h, tq, tk, d in ((1, 2, 100, 100, 64), (1, 2, 50, 130, 128),
                                (1, 2, 130, 50, 64), (2, 1, 1, 77, 128),
                                (1, 2, 256, 256, 128), (1, 3, 300, 300, 128),
                                (1, 2, 200, 333, 64), (1, 2, 333, 200, 128),
                                (2, 70, 200, 200, 64)):
            q, k, v = put(dtype,
                          *(rng.standard_normal((b, h, t, d), np.float32)
                            for t in (tq, tk, tk)))
            route = "tma" if dtype == torch.bfloat16 else "tiled"
            for causal in (True, False):
                got = routed(flash, route,
                             lambda: flash(q, k, v, causal=causal))
                err = _close(got, ref.flash_attention(q, k, v, causal=causal),
                             dtype, gemm=False)
                if causal and tq > tk and got[:, :, :tq - tk].any():
                    fail(f"flash_attention {tag}: dead causal rows not zero")
                worst["flash_attention", tag] = max(
                    worst["flash_attention", tag], err)
                cases["flash_attention"] += 1
        if dtype == torch.bfloat16:
            # bf16 that TMA cannot address (a base 2 bytes off 16) stays
            # on the tiled kernels
            x = put(dtype, rng.standard_normal(2 * 64 * 64 + 1,
                                               np.float32))[0]
            w = put(dtype, rng.standard_normal((2, 64, 128), np.float32))[0]
            x = x[1:].view(2 * 64, 64)
            got = routed(ragged, "tiled", lambda: ragged(x, w, capacity=64))
            _close(got, ref.ragged_matmul(x, w, 64), dtype, gemm=True)
            q = put(dtype, rng.standard_normal(2 * 100 * 64 + 1,
                                               np.float32))[0]
            q = q[1:].view(1, 2, 100, 64)
            k, v = put(dtype, *(rng.standard_normal((1, 2, 100, 64),
                                                    np.float32)
                                for _ in range(2)))
            got = routed(flash, "tiled", lambda: flash(q, k, v))
            _close(got, ref.flash_attention(q, k, v), dtype, gemm=False)
        # page 8 and 16, d 64 and 128, splits of 256 tokens crossed
        for b, h, d, p, page, nmax in ((3, 4, 64, 16, 8, 5),
                                       (1, 8, 128, 8, 16, 3),
                                       (5, 8, 128, 64, 16, 40),
                                       (4, 3, 128, 9, 8, 70)):
            q, kp, vp, pt, seq = _paged_edges(rng, b, h, d, p, page, nmax)
            q, kp, vp = put(dtype, q, kp, vp)
            pt, seq = (torch.from_numpy(a).to(dev) for a in (pt, seq))
            got = paged(q, kp, vp, pt, seq)
            err = _close(got, ref.paged_attention(q, kp, vp, pt, seq), dtype,
                         gemm=False)
            if b > 2 and (got[0].any() or got[2].any()):
                fail(f"paged_attention {tag}: dead rows not zero")
            worst["paged_attention", tag] = max(
                worst["paged_attention", tag], err)
            cases["paged_attention"] += 1
    torch.cuda.synchronize()
    print(f"[kernels-dense] launches by route {dict(routes)}")
    print(f"[kernels-dense] {dict(cases)} cases agree with the plain "
          f"versions (float32 rtol=atol {GEMM_TOL} GEMM / {ATTN_TOL} "
          f"attention; bfloat16 rtol {BF16_GEMM_RTOL} atol "
          f"{BF16_GEMM_RTOL}*max|want| GEMM / rtol=atol {BF16_ATTN_TOL} "
          f"attention); max abs error "
          f"{ {f'{k}/{t}': v for (k, t), v in sorted(worst.items())} } "
          f"({time.perf_counter() - t0:.1f} s)")


def _adaptive_reps(fn) -> int:
    """Calls of ``fn`` that take about TIMING_S / 5 on the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(stop), 1e-3)
    return max(1, min(200, int(TIMING_S * 1e3 / 5 / one)))


def _full_width_inputs(gen):
    """Seeded bfloat16 inputs at the three models' widths, made on the
    card; returns {kernel: (args, work)}."""
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(scale).to(bf)

    # Kimi-K2 expert FFN (repro.configs.kimi_k2_1t_a32b): w_gate (E, D, F)
    e, d, f, top_k = 384, 7168, 2048, 8
    cap = round_capacity(2048, e, top_k, 1.25)
    x = randn(e * cap, d)
    w = randn(e, d, f, scale=d ** -0.5)
    ragged = ((x, w, cap), {
        "flop": 2 * e * cap * d * f,
        "bytes": 2 * (x.numel() + w.numel() + e * cap * f),
        "shape": {"E": e, "capacity": cap, "D": d, "F": f,
                  "dtype": "bfloat16"}})

    # Mistral-NeMo-12B prefill (repro.configs.mistral_nemo_12b): 32 query
    # heads, head_dim 128, T = 4096, causal
    b, h, t, hd = 1, 32, 4096, 128
    q, k, v = (randn(b, h, t, hd) for _ in range(3))
    pairs = t * (t + 1) // 2  # live (query, key) pairs, tq == tk
    flash = ((q, k, v), {
        "flop": 4 * hd * pairs * b * h,
        "bytes": 2 * 4 * q.numel(),
        "shape": {"B": b, "H": h, "T": t, "d": hd, "causal": True,
                  "dtype": "bfloat16"}})

    # Mistral-NeMo-12B decode: 8 KV heads, 32 sequences of up to 4096
    # tokens in pages of 16, a pool of 8192 pages in shuffled order
    b, h, page, n_max, pool = 32, 8, 16, 256, 8192
    rng = np.random.default_rng(12)
    seq = rng.integers(1, page * n_max + 1, b).astype(np.int32)
    order = rng.permutation(pool).astype(np.int32)
    pt = np.full((b, n_max), -1, np.int32)
    for i in range(b):
        used = (int(seq[i]) + page - 1) // page
        pt[i, :used] = order[i * n_max:i * n_max + used]
    qd = randn(b, h, hd)
    kp, vp = randn(pool, page, h, hd), randn(pool, page, h, hd)
    pt_t, seq_t = (torch.from_numpy(a).to(dev) for a in (pt, seq))
    live = int(seq.sum())
    paged = ((qd, kp, vp, pt_t, seq_t), {
        "flop": 4 * hd * live * h,
        "bytes": 2 * 2 * live * h * hd + 2 * 2 * qd.numel()
        + 4 * (pt.size + seq.size),
        "shape": {"B": b, "H": h, "d": hd, "page": page, "n_max": n_max,
                  "P": pool, "live_slots": live, "dtype": "bfloat16"}})
    return {"ragged_matmul": ragged, "flash_attention": flash,
            "paged_attention": paged}


def _tiled_call(name: str, args):
    """A call of the tiled bf16 kernel (``csrc/<name>.cu``, the route of
    float32 and of bf16 that TMA cannot address) through its C entry, on
    the same inputs, for the old against new timing; returns (call,
    output)."""
    from repro_torch.kernels import build
    lib = build.load(name)
    if name == "ragged_matmul":
        x, w, cap = args
        out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype,
                          device=x.device)
        e, d, f = w.shape

        def call():
            build.check(lib.ragged_matmul_bf16(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), e, cap, d, f,
                torch.cuda.current_stream().cuda_stream), name)
    else:
        q, k, v = args
        out = torch.empty_like(q)
        b, h, tq, d = q.shape

        def call():
            build.check(lib.flash_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, tq, k.shape[2], d, 1,
                torch.cuda.current_stream().cuda_stream), name)
    return call, out


def phase_api_full() -> list:
    """The kernel API's path at full width: each kernel once through
    ``repro_torch.kernels.ops``, launch counts (and the GEMM's and flash's
    routes) read around that run, then each held against its plain
    version and timed, the tiled kernels of the two redesigned ones
    beside them."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g, s = _counters()
    ragged, flash, paged = _dense_kernels()
    counters = {"spec_gather": g, "spec_scatter_add": s,
                "ragged_matmul": ragged, "flash_attention": flash,
                "paged_attention": paged}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(12)
    inputs = _full_width_inputs(gen)
    torch.cuda.synchronize()
    print(f"[api] inputs made on the card in "
          f"{time.perf_counter() - t0:.1f} s")

    # the path: the public API, each kernel once
    for c in counters.values():
        c.launches = 0
    for c in (ragged, flash):
        c.route_launches = dict.fromkeys(c.route_launches, 0)
    outs = {
        "ragged_matmul": ops.ragged_matmul(*inputs["ragged_matmul"][0]),
        "flash_attention": ops.flash_attention(*inputs["flash_attention"][0],
                                               causal=True),
        "paged_attention": ops.paged_attention(*inputs["paged_attention"][0]),
    }
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    routes = {"ragged_matmul": dict(ragged.route_launches),
              "flash_attention": dict(flash.route_launches)}
    want = {"spec_gather": 0, "spec_scatter_add": 0, "ragged_matmul": 1,
            "flash_attention": 1, "paged_attention": 1}
    if launches != want:
        fail(f"api path launches {launches} != {want}")
    for name, by_route in routes.items():
        if by_route != {"tma": 1, "tiled": 0}:
            fail(f"api path: {name} launches by route {by_route}, want one "
                 f"by tma")

    plain = {"ragged_matmul": lambda x, w, c: ref.ragged_matmul(x, w, c),
             "flash_attention": lambda q, k, v: ref.flash_attention(q, k, v),
             "paged_attention": ref.paged_attention}
    kernel = {"ragged_matmul": lambda x, w, c: ragged(x, w, capacity=c),
              "flash_attention": lambda q, k, v: flash(q, k, v),
              "paged_attention": paged}
    library = {  # yardsticks only; the port never calls them
        "ragged_matmul": lambda x, w, c: torch.bmm(
            x.view(w.shape[0], c, w.shape[1]), w),
        "flash_attention": lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True),
        "paged_attention": None}
    sources = {
        "ragged_matmul": (
            "src/repro_torch/kernels/csrc/ragged_matmul_sm90.cu",
            "src/repro/kernels/ragged_matmul.py:65"),
        "flash_attention": (
            "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
            "src/repro/kernels/flash_attention.py:90"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:110")}
    records = []
    for name in ("ragged_matmul", "flash_attention", "paged_attention"):
        args, work = inputs[name]
        t1 = time.perf_counter()
        want_out = plain[name](*args)
        err = _close(outs.pop(name), want_out, torch.bfloat16,
                     gemm=name == "ragged_matmul")
        saved = {n: c.launches for n, c in counters.items()}
        saved_routes = {n: dict(counters[n].route_launches) for n in routes}
        kern = lambda: kernel[name](*args)
        ms = device_ms(kern, reps=_adaptive_reps(kern))
        eager = call_ms(kern, reps=_adaptive_reps(kern))
        pl = lambda: plain[name](*args)
        plain_ms = call_ms(pl, reps=_adaptive_reps(pl))
        lib_ms = None
        if library[name] is not None:
            lib = lambda: library[name](*args)
            lib_ms = device_ms(lib, reps=_adaptive_reps(lib))
        old = {}
        if name in routes:
            call, out = _tiled_call(name, args)
            call()
            torch.cuda.synchronize()
            old = {"tiled_ms": device_ms(call, reps=_adaptive_reps(call)),
                   "tiled_max_abs_err": _close(
                       out, want_out, torch.bfloat16,
                       gemm=name == "ragged_matmul"),
                   "tiled_source": f"src/repro_torch/kernels/csrc/{name}.cu"}
            del call, out
        del want_out
        for n, c in counters.items():
            c.launches = saved[n]
        for n, r in saved_routes.items():
            counters[n].route_launches = r
        t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = work["flop"] / BF16_FLOP_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        rate = ({"achieved_tflop_s": work["flop"] / ms / 1e9}
                if bound_by == "operations" else
                {"achieved_tb_s": work["bytes"] / ms / 1e9})
        src, replaces = sources[name]
        print(f"[api] {name} {work['shape']}: launches {launches[name]}"
              + (f" (by route {routes[name]})" if name in routes else "")
              + f"; max abs err vs plain {err}; device {ms:.4f} ms (CUDA "
              f"graph replay), eager call {eager:.4f} ms, plain "
              f"{plain_ms:.4f} ms (eager), library "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None else
                 "none (no single PyTorch call computes attention through a "
                 "page table)")
              + f"; bound {bound_ms:.4f} ms by {bound_by} "
              f"({work['flop'] / 1e9:.2f} GFLOP, {work['bytes'] / 1e6:.1f} "
              f"MB); " + ", ".join(
                  f"{k.replace('achieved_', '').replace('_', '/')} "
                  f"{v:.1f}" for k, v in rate.items())
              + f", {bound_ms / ms:.1%} of the bound"
              + (f"; tiled kernel {old['tiled_ms']:.4f} ms (max abs err "
                 f"{old['tiled_max_abs_err']}), {old['tiled_ms'] / ms:.1f}x "
                 f"the new one" if old else "")
              + f" ({time.perf_counter() - t1:.1f} s)")
        records.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            **rate, "bound_share": bound_ms / ms, **old,
            "call_ms": eager, "shape": work["shape"],
            "flop": work["flop"], "bytes": work["bytes"]})
        del args
        inputs.pop(name)
        torch.cuda.empty_cache()
    return records

# ---------------------------------------------------------------------------
# the serving path: the model stack and Engine at Kimi-K2's width
# ---------------------------------------------------------------------------

#: the serving phase's traffic: 8 requests of seeded length in [128, 512]
#: (the longest pinned to 512, so the one wave's prefill dispatches
#: 8 x 512 rows), 16 new tokens each, 8 slots, a cache of 544
SERVE = dict(requests=8, prompt=(128, 512), max_new=16, slots=8,
             max_len=544, seed=15)


class _TimedModel:
    """The engine's model with a host clock around each call (each call
    ends in a device sync: the engine reads its poison count), a check
    that its logits are finite, and the calls' times kept."""

    def __init__(self, model):
        self.model = model
        self.prefill_s: list = []
        self.decode_s: list = []

    def _timed(self, fn, into, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"serve.{fn.__name__}"):
            out = fn(*args, **kw)
            torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        if not torch.isfinite(out[0]).all():
            fail("serve: non-finite logits")
        return out

    def prefill(self, *args, **kw):
        return self._timed(self.model.prefill, self.prefill_s, *args, **kw)

    def decode_step(self, *args, **kw):
        return self._timed(self.model.decode_step, self.decode_s, *args,
                           **kw)


#: kernel-name fragments of each device-time category of the profile
KERNEL_KINDS = (
    ("spec kernels", ("spec_gather", "spec_scatter")),
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass", "splitK")),
    ("softmax", ("softmax",)),
    ("indexing", ("index", "scatter", "gather", "cumsum", "scan",
                  "topk", "sort", "radix", "one_hot")),
)


def _kind(name: str) -> str:
    low = name.lower()
    for kind, parts in KERNEL_KINDS:
        if any(p.lower() in low for p in parts):
            return kind
    return "other"


def _serve_profile(serve) -> dict:
    """One more ``spec-kernel`` wave under ``torch.profiler``: for the
    prefill call and the decode steps, the host window, the device's busy
    time in it (the union of kernel and copy intervals), the idle share,
    busy time by kind of kernel, and the top kernels."""
    from torch.autograd import DeviceType
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        serve("spec-kernel")
        torch.cuda.synchronize()
    events = prof.events()
    windows = {"prefill": [], "decode_step": []}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name in (
                "serve.prefill", "serve.decode_step"):
            windows[ev.name.split(".")[1]].append(
                (ev.time_range.start, ev.time_range.end))
    # device work: kernels and copies, not the ranges' own annotations
    kernels = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                     for ev in events if ev.device_type != DeviceType.CPU
                     and not ev.name.startswith("serve."))
    out = {}
    for phase, spans in windows.items():
        window = sum(e - b for b, e in spans)
        busy = 0.0
        kinds = collections.Counter()
        names = collections.Counter()
        for b, e in spans:
            end = b
            for kb, ke, name in kernels:
                kb, ke = max(kb, b), min(ke, e)
                if ke <= kb:
                    continue
                kinds[_kind(name)] += ke - kb
                names[name[:70]] += ke - kb
                busy += max(0.0, ke - max(kb, end))
                end = max(end, ke)
        out[phase] = {
            "calls": len(spans), "window_ms": window / 1e3,
            "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / window if window else None,
            "by_kind_ms": {k: v / 1e3 for k, v in kinds.most_common()},
            "top_kernels_ms": {k: v / 1e3 for k, v in names.most_common(8)}}
    return out


def _serve_small_agrees() -> None:
    """The engine on the card against the same engine on the CPU, on a
    small float32 input (Kimi-K2's smoke config): the same tokens."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import base as cbase
    from repro_torch.serve.engine import Engine, Request
    cfg = cbase.smoke(cbase.get("kimi_k2_1t_a32b"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 7)]
    params = Engine(cfg, slots=3, max_len=24, device="cpu").params
    got = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, tree_map(lambda t: t.to(dev), params), slots=3,
                     max_len=24,
                     dispatch="spec-kernel", device=dev)
        got[dev] = eng.run([Request(rid=i, prompt=p, max_new=6)
                            for i, p in enumerate(prompts)])
        got[dev, "poison"] = [w.moe_poison for w in eng.wave_stats]
    if got["cpu"] != got["cuda"] or got["cpu", "poison"] != \
            got["cuda", "poison"]:
        fail(f"serve: small float32 run differs cuda/cpu: {got}")


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose base sits 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _bf16_sweep() -> int:
    """The bf16 entries against their plain versions over edge cases: d
    odd and even, bases 16-byte aligned and 2 bytes off (the gather's 16-,
    4- and 2-byte copies, the scatter's paired and single atomics),
    poisoned rows, indices past the table, n = 0, duplicates.  Gather and
    unique-destination scatter bitwise, duplicates within
    ``ref.bf16_sum_bound`` of the float32 sum."""
    from repro_torch.kernels import ref
    g, s = _counters()
    dev = torch.device("cuda")
    rng = np.random.default_rng(16)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).bfloat16()

    cases = 0
    for rows, d, n in ((1, 1, 1), (61, 7, 100), (384, 8, 37),
                       (40, 7168, 64), (96, 33, 0), (3000, 130, 4099)):
        idx = torch.from_numpy(rng.integers(-3, rows + 4, n).astype(
            np.int32)).to(dev)
        vals = bf16(n, d)
        uniq = torch.from_numpy(rng.permutation(max(rows, n))[:n].astype(
            np.int32)).to(dev)
        uniq[::3] = -1
        table = bf16(rows, d)
        for place in (lambda t: t.clone(), _unaligned):
            tab = place(table)
            if not torch.equal(g(tab, idx), ref.spec_gather(tab, idx)):
                fail(f"spec_gather bf16 rows={rows} d={d} n={n} differs")
            zero = place(torch.zeros((max(rows, n), d), dtype=torch.bfloat16,
                                     device=dev))
            got = s(zero, uniq, place(vals))
            want = ref.spec_scatter_add(torch.zeros_like(zero), uniq, vals)
            if not torch.equal(got, want):
                fail(f"spec_scatter_add bf16 unique rows={rows} d={d} n={n} "
                     f"differs")
            got = s(place(table), idx, place(vals)).float()
            want = ref.spec_scatter_add(table.float(), idx, vals.float())
            if not ((got - want).abs() <= ref.bf16_sum_bound(
                    table, idx, vals)).all():
                fail(f"spec_scatter_add bf16 duplicates rows={rows} d={d} "
                     f"n={n} past the bound")
            cases += 1
    torch.cuda.synchronize()
    return cases


def _moe_kernel_inputs(n_tok, cap, gen, d=7168, n_experts=384, top_k=8):
    """The MoE dispatch's kernel inputs at ``n_tok`` tokens: each token's
    8 experts drawn at random, slots from the port's own assignment
    (poisoned past ``cap``), bf16 rows of width ``d`` made on the card."""
    from repro_torch.models.moe import spec_dispatch_indices
    dev = torch.device("cuda")
    probs = torch.rand((n_tok, n_experts), generator=gen, device=dev)
    gates, experts = probs.topk(top_k, dim=-1)
    slot, _ = spec_dispatch_indices(gates, experts, cap, n_experts)
    idx = slot.reshape(-1).contiguous()
    x = torch.randn((n_tok, d), generator=gen, device=dev).bfloat16()
    src = x.repeat_interleave(top_k, dim=0)
    h = torch.randn((n_experts * cap, d), generator=gen,
                    device=dev).bfloat16()
    return idx, src, h


def _bf16_line(name, idx, table, values):
    """One bf16 entry at one shape: bitwise against its plain version,
    then device ms by CUDA-graph replay of the kernel alone (its C entry
    into a preallocated output), the plain version and one library call,
    and the byte bound from these inputs."""
    from repro_torch.kernels import build, ref
    g, s = _counters()
    saved = {c: (c.launches, dict(c.route_launches), dict(c.entry_launches))
             for c in (g, s)}
    n, d, rows = idx.shape[0], table.shape[1], table.shape[0]
    live = idx >= 0
    n_live = int(live.sum())
    safe = idx.clamp(0, rows - 1).long()
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if name == "spec_gather":
        got, want = g(table, idx), ref.spec_gather(table, idx)
        out = torch.empty_like(got)
        fn = build.load("spec_gather").spec_gather_bf16
        kern = lambda: build.check(fn(table.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), rows, n, d, stream()),
                                   name)
        plain = lambda: ref.spec_gather(table, idx)
        lib_call = lambda: table.index_select(0, safe)
        # index read, live rows read, every output row written
        nbytes = 4 * n + 2 * d * n_live + 2 * d * n
    else:
        got = s(table.clone(), idx, values)
        want = ref.spec_scatter_add(table.clone(), idx, values)
        t2 = table.clone()
        fn = build.load("spec_scatter").spec_scatter_add_bf16
        kern = lambda: build.check(fn(t2.data_ptr(), idx.data_ptr(),
                                      values.data_ptr(), rows, n, d,
                                      stream()), name)
        plain = lambda: ref.spec_scatter_add(t2, idx, values)
        vmask = torch.where(live[:, None], values, torch.zeros_like(values))
        lib_call = lambda: t2.index_add_(0, safe, vmask)
        uniq = int(torch.unique(safe[live]).numel())
        # index and live values read, each live destination row read and
        # written once
        nbytes = 4 * n + 2 * d * n_live + 2 * 2 * d * uniq
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{name} bf16 at n={n} d={d} differs from its plain version")
    err = (got.float() - want.float()).abs().max().item() if n else 0.0
    del got, want
    reps = 20 if n * d > 1e7 else 200
    ms = device_ms(kern, reps=reps)
    plain_ms = device_ms(plain, reps=reps)
    lib_ms = device_ms(lib_call, reps=reps)
    for c, (launches, routes, entries) in saved.items():
        c.launches, c.route_launches, c.entry_launches = (launches, routes,
                                                          entries)
    return {"n": n, "d": d, "rows": rows, "n_live": n_live,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def _router_topk_line(n_tok: int, n_experts: int, top_k: int) -> None:
    """The router's top-k at the prefill shape: the stable descending
    sort ``_route`` takes (ties in ``jax.lax.top_k``'s order) beside the
    ``torch.topk`` it replaced, device time by graph replay."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    logits = torch.randn(n_tok, n_experts, device="cuda", generator=gen)
    probs = torch.softmax(logits.bfloat16().float(), dim=-1)
    sort_ms = device_ms(lambda: torch.sort(probs, dim=-1, descending=True,
                                           stable=True))
    topk_ms = device_ms(lambda: torch.topk(probs, top_k, dim=-1,
                                           sorted=True))
    print(f"[serve] router top-{top_k} of ({n_tok}, {n_experts}) float32: "
          f"stable sort {sort_ms * 1e3:.2f} us, torch.topk "
          f"{topk_ms * 1e3:.2f} us (device, graph replay; {smi()})")


def phase_serve_full() -> list:
    """The serving path at Kimi-K2's full width, one layer group: the
    engine serves the same requests through dispatch="spec-kernel" (the
    main path, its launches counted) and dispatch="spec" on the same
    parameters, which must commit the same tokens with the same poison
    counts; then the two bf16 entries are held against their plain
    versions at the prefill and decode shapes and timed."""
    import dataclasses
    import gc
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import base as cbase
    from repro_torch.kernels import ref
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import round_capacity as moe_capacity
    from repro_torch.serve.engine import Engine, Request
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _serve_small_agrees()
    cases = _bf16_sweep()
    print(f"[serve] small float32 engine run equal cuda/cpu; {cases} bf16 "
          f"edge cases x 2 entries agree with the plain versions "
          f"({time.perf_counter() - t0:.1f} s)")

    cfg = dataclasses.replace(cbase.get("kimi_k2_1t_a32b"), n_layers=1)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SERVE["seed"])
    params = build_model(cfg).init(gen, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[serve] {cfg.name} at full width, n_layers cut to 1 (one "
          f"[attn, moe] group): d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"of {cfg.hd}, {cfg.n_kv_heads} KV heads, {cfg.n_experts} experts "
          f"top-{cfg.top_k} of ff {cfg.moe_d_ff} + {cfg.n_shared_experts} "
          f"shared, vocab {cfg.vocab}, {cfg.dtype}; {n_params / 1e9:.2f}e9 "
          f"parameters, {(torch.cuda.memory_allocated() - before) / 1e9:.2f} "
          f"GB, drawn on the card in {time.perf_counter() - t0:.1f} s "
          f"(device memory in use before: {before / 1e9:.2f} GB)")

    rng = np.random.default_rng(SERVE["seed"])
    lo, hi = SERVE["prompt"]
    lens = rng.integers(lo, hi + 1, SERVE["requests"])
    lens[int(np.argmax(lens))] = hi
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]

    def serve(dispatch):
        eng = Engine(cfg, params, slots=SERVE["slots"],
                     max_len=SERVE["max_len"], dispatch=dispatch, device=dev)
        eng.model = timed = _TimedModel(eng.model)
        reqs = [Request(rid=i, prompt=p, max_new=SERVE["max_new"])
                for i, p in enumerate(prompts)]
        res = eng.run(reqs)
        if any(r.failed or r.truncated for r in reqs) or eng.events:
            fail(f"serve {dispatch}: events {eng.events}")
        if sorted(res) != list(range(len(prompts))) or any(
                len(v) != SERVE["max_new"] or not all(
                    0 <= t < cfg.vocab for t in v) for v in res.values()):
            fail(f"serve {dispatch}: results {res}")
        return res, eng.wave_stats, timed

    serve("spec-kernel")  # warm-up: cuBLAS handles, the kernels' build
    g, s = _counters()
    _reset()
    res_k, waves_k, timed_k = serve("spec-kernel")
    torch.cuda.synchronize()
    launches = {"spec_gather": (g.launches, dict(g.route_launches),
                                g.entry_launches["spec_gather_bf16"]),
                "spec_scatter_add": (s.launches, dict(s.route_launches),
                                     s.entry_launches[
                                         "spec_scatter_add_bf16"])}
    peak = torch.cuda.max_memory_allocated()
    res_s, waves_s, timed_s = serve("spec")
    torch.cuda.synchronize()
    if (g.launches, s.launches) != (launches["spec_gather"][0],
                                    launches["spec_scatter_add"][0]):
        fail("serve: dispatch='spec' launched a spec kernel")
    forwards = 1 + SERVE["max_new"]
    for name, (n, routes, bf16) in launches.items():
        if n != forwards or bf16 != forwards or routes != {
                "tensor": forwards, "staged": 0}:
            fail(f"serve: {name} launched {n} times (by route {routes}, "
                 f"bf16 entry {bf16}), want {forwards}: once per MoE "
                 f"forward (1 prefill + {SERVE['max_new']} decode steps)")
    if res_k != res_s:
        fail(f"serve: spec-kernel tokens {res_k} != spec tokens {res_s}")
    pk = [(w.moe_poison, w.moe_requests) for w in waves_k]
    if pk != [(w.moe_poison, w.moe_requests) for w in waves_s]:
        fail(f"serve: poison counts differ: {pk} vs "
             f"{[(w.moe_poison, w.moe_requests) for w in waves_s]}")
    if len(waves_k) != 1:
        fail(f"serve: {len(waves_k)} waves, want 1")
    wave = waves_k[0]
    plen = int(lens.max())
    cap_p = moe_capacity(SERVE["requests"] * plen, cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
    cap_d = moe_capacity(SERVE["requests"], cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
    stats = {
        dispatch: {"wall_s": w[0].wall_s,
                   "prefill_ms": t.prefill_s[0] * 1e3,
                   "decode_ms_per_step": float(np.mean(t.decode_s)) * 1e3,
                   "decode_steps": len(t.decode_s),
                   "tok_s": w[0].tokens / w[0].wall_s}
        for dispatch, w, t in (("spec-kernel", waves_k, timed_k),
                               ("spec", waves_s, timed_s))}
    for dispatch, st in stats.items():
        print(f"[serve] dispatch={dispatch}: prefill {st['prefill_ms']:.2f} "
              f"ms ({SERVE['requests']} x {plen} rows, capacity {cap_p}); "
              f"decode {st['decode_ms_per_step']:.3f} ms a step "
              f"({st['decode_steps']} steps, capacity {cap_d}); wave "
              f"{st['wall_s'] * 1e3:.1f} ms, {wave.tokens} tokens, "
              f"{st['tok_s']:.1f} tokens/s")
    profile = _serve_profile(serve)
    for phase, pr in profile.items():
        if not pr["busy_ms"]:
            fail(f"serve: the profiler saw no device work in {phase}")
        print(f"[serve-profile] {phase} ({pr['calls']} calls, profiled): "
              f"window {pr['window_ms']:.2f} ms, device busy "
              f"{pr['busy_ms']:.2f} ms, idle {pr['idle_share']:.1%}; by "
              f"kind " + ", ".join(f"{k} {v:.2f}" for k, v in
                                   pr["by_kind_ms"].items())
              + " ms; top kernels " + "; ".join(
                  f"{k} {v:.2f}" for k, v in pr["top_kernels_ms"].items())
              + " ms")
    print(f"[serve] same tokens for all {len(res_k)} requests and same "
          f"poison under both dispatches: {wave.moe_poison} of "
          f"{wave.moe_requests} dispatch requests poisoned "
          f"({wave.moe_poison / wave.moe_requests:.4%}); launches "
          f"{ {k: v[0] for k, v in launches.items()} } (all by the bf16 "
          f"entry); peak device memory {peak / 1e9:.2f} GB; prompt lengths "
          f"{sorted(int(n) for n in lens)}")
    for n_tok in (SERVE["requests"] * plen, SERVE["slots"]):
        _router_topk_line(n_tok, cfg.n_experts, cfg.top_k)

    # the two bf16 entries at the path's shapes, against their plain
    # versions, timed
    t0 = time.perf_counter()
    kgen = torch.Generator(device=dev).manual_seed(17)
    shapes = {}
    for tag, n_tok, cap in (("prefill", SERVE["requests"] * plen, cap_p),
                            ("decode", SERVE["requests"], cap_d)):
        idx, src, h = _moe_kernel_inputs(n_tok, cap, kgen, d=cfg.d_model,
                                         n_experts=cfg.n_experts,
                                         top_k=cfg.top_k)
        zeros = torch.zeros_like(h)
        shapes[tag] = {
            "spec_scatter_add": _bf16_line("spec_scatter_add", idx, zeros,
                                           src),
            "spec_gather": _bf16_line("spec_gather", idx, h, None)}
        del idx, src, h, zeros
        torch.cuda.empty_cache()
    # duplicates at the prefill shape: many requests into few rows
    n = SERVE["requests"] * plen * cfg.top_k
    rows = 4096
    dup = torch.randint(-1, rows, (n,), generator=kgen, device=dev,
                        dtype=torch.int32)
    vals = torch.randn((n, cfg.d_model), generator=kgen,
                       device=dev).bfloat16()
    table = torch.randn((rows, cfg.d_model), generator=kgen,
                        device=dev).bfloat16()
    got = s(table.clone(), dup, vals).float()
    want = ref.spec_scatter_add(table.float(), dup, vals.float())
    bound = ref.bf16_sum_bound(table, dup, vals)
    dup_err = (got - want).abs()
    if not (dup_err <= bound).all():
        fail("spec_scatter_add bf16 duplicates past bf16_sum_bound")
    dup_err, dup_bound = dup_err.max().item(), bound.max().item()
    del dup, vals, table, got, want, bound
    for name in ("spec_gather", "spec_scatter_add"):
        for tag, r in ((t, shapes[t][name]) for t in ("prefill", "decode")):
            print(f"[serve-kernels] {name} bf16 {tag} n={r['n']} d={r['d']} "
                  f"rows={r['rows']} live={r['n_live']}: bitwise equal to "
                  f"the plain version; device {r['ms'] * 1e3:.2f} us "
                  f"(CUDA-graph replay), plain {r['plain_ms'] * 1e3:.2f} us, "
                  f"library {r['library_ms'] * 1e3:.2f} us "
                  f"({'index_select' if name == 'spec_gather' else 'index_add_'}"
                  f"); byte bound {r['bound_ms'] * 1e3:.2f} us "
                  f"({r['bytes'] / 1e9:.3f} GB), "
                  f"{r['bound_ms'] / r['ms']:.1%} of it")
    print(f"[serve-kernels] spec_scatter_add bf16 duplicates n={n} into "
          f"{rows} rows: max |got - float32 sum| {dup_err:.4g}, within "
          f"bf16_sum_bound (max {dup_bound:.4g}) "
          f"({time.perf_counter() - t0:.1f} s)")
    records = []
    for name, lib, replaces in (
            ("spec_gather", "index_select",
             "src/repro/kernels/spec_gather.py:114"),
            ("spec_scatter_add", "index_add_",
             "src/repro/kernels/spec_scatter.py:124")):
        r = shapes["prefill"][name]
        records.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{name.replace('_add', '')}.cu",
            "replaces": replaces, "launches": launches[name][0],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
            "library": lib, "shape": {k: r[k] for k in ("n", "d", "rows",
                                                        "n_live")},
            "decode": shapes["decode"][name],
            **({"duplicates_max_abs_err": dup_err,
                "duplicates_max_bound": dup_bound}
               if name == "spec_scatter_add" else {}),
            "serve": {"stats": stats, "profile": profile,
                      "moe_poison": wave.moe_poison,
                      "moe_requests": wave.moe_requests,
                      "peak_bytes": peak, "prompt_lens": lens.tolist()}})
    del params, timed_k, timed_s
    gc.collect()
    torch.cuda.empty_cache()
    return records


def main() -> None:
    """Run every phase; print the result lines only if all passed."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    t0 = time.perf_counter()
    phase_build()
    phase_kernels()
    phase_parity()
    phase_sim()
    line = phase_line(*phase_full())
    phase_kernels_dense()
    line["kernels"] += phase_api_full()
    line["kernels"] += phase_serve_full()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
