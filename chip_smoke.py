"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with
``nvcc`` (into ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card, runs every workload of
``repro_torch.bench_irregular`` through ``repro_torch.codegen.run`` on the
card and checks it bit for bit against the port's sequential interpreter,
then runs the full-size codegen path (hist over 2**20 elements, spmv and
sort at n=1024) and times it.  Phases print as they finish; the last lines
are one ``{"kernels": [...]}`` JSON object, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line is printed.  Without a CUDA device, or outside a
checkout, it exits non-zero at once.
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


def phase_build() -> None:
    """Build every kernel in parallel and report the compiler's view."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    secs = time.perf_counter() - t0
    print(f"[build] nvcc sm_90a, {len(build.SIGNATURES)} sources in "
          f"{secs:.2f} s -> {build.BUILD_DIR}")
    for name, log in sorted(build.BUILD_LOG.items()):
        for line in log.strip().splitlines():
            if "Used" in line and "registers" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] card: {smi()}")


def phase_kernels() -> None:
    """Both kernels against their plain versions over a shape sweep."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spec_gather import spec_gather
    from repro_torch.kernels.spec_scatter import spec_scatter_add
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    cases = 0
    for dtype in (torch.int32, torch.float32):
        for d in (1, 7, 128):
            for n in (0, 1, 5, 8, 37, 512, 4099):
                rows = 61
                # -1 poison, in-range rows, and rows past the end (clip)
                idx_np = rng.integers(-1, rows + 6, n).astype(np.int32)
                if dtype == torch.int32:
                    tab_np = rng.integers(-2 ** 31, 2 ** 31, (rows, d),
                                          dtype=np.int64).astype(np.int32)
                    val_np = rng.integers(-2 ** 31, 2 ** 31, (n, d),
                                          dtype=np.int64).astype(np.int32)
                else:
                    tab_np = rng.standard_normal((rows, d)).astype(np.float32)
                    val_np = rng.standard_normal((n, d)).astype(np.float32)
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
    print(f"[kernels] {cases} cases x 2 kernels agree with the plain "
          f"versions (int32 bitwise, gather float32 bitwise, scatter "
          f"float32 rtol=0 atol={F32_ATOL})")


def _counters():
    from repro_torch.kernels.spec_gather import spec_gather
    from repro_torch.kernels.spec_scatter import spec_scatter_add
    return spec_gather, spec_scatter_add


def _reset() -> None:
    g, s = _counters()
    g.launches = 0
    s.launches = 0


def _launches():
    g, s = _counters()
    return g.launches, s.launches


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
                for device in ("cuda", "cpu"):
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
                if pname == "spec" and not (g > 0 and s > 0):
                    fail(f"{tag}: the kernels were not launched")
                legs += 1
    print(f"[parity] {legs} legs (11 workloads x dae/spec x vector/"
          f"state-machine) bit-exact on cuda, stats equal to the cpu run, "
          f"launch counts equal to gather/scatter calls "
          f"({time.perf_counter() - t0:.1f} s)")


def _census(shapes, args):
    """Wrap the drivers' kernel entry points to record launch shapes."""
    from repro_torch.codegen import torch_backend, vector
    g0, s0 = _counters()

    def g(table, idx):
        key = ("spec_gather", table.shape[0], idx.shape[0], table.shape[1])
        shapes[key] += 1
        args.setdefault(key, (table.clone(), idx.clone()))
        return g0(table, idx)

    def s(table, idx, values):
        key = ("spec_scatter_add", table.shape[0], idx.shape[0],
               table.shape[1])
        shapes[key] += 1
        args.setdefault(key, (table.clone(), idx.clone(), values.clone()))
        return s0(table, idx, values)

    saved = (vector.spec_gather, vector.spec_scatter_add,
             torch_backend.spec_gather, torch_backend.spec_scatter_add)
    vector.spec_gather = torch_backend.spec_gather = g
    vector.spec_scatter_add = torch_backend.spec_scatter_add = s

    def restore():
        (vector.spec_gather, vector.spec_scatter_add,
         torch_backend.spec_gather, torch_backend.spec_scatter_add) = saved
    return restore


def phase_full():
    """The main path at full size; returns launches, shapes and args."""
    from repro_torch import codegen
    from repro_torch.bench_irregular import ALL
    from repro_torch.codegen.emit import compile_mode
    from repro_torch.core import interp, pipeline
    totals = [0, 0]
    kernel_ms = [0.0, 0.0]
    shapes: collections.Counter = collections.Counter()
    args: dict = {}
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
        restore = _census(shapes, args)
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
        parts = ("spec_gather_kernel", "spec_scatter_add_kernel", "Memcpy")
        dev_us = collections.Counter()
        for ev in prof.key_averages():
            for part in parts:
                if part in ev.key:
                    dev_us[part] += ev.self_device_time_total
        for part in parts:
            if not dev_us[part]:
                fail(f"full {name}: the profiler saw no {part} device time")
        gk = dev_us["spec_gather_kernel"] / 1e3
        sk = dev_us["spec_scatter_add_kernel"] / 1e3
        cp = dev_us["Memcpy"] / 1e3
        kernel_ms[0] += gk
        kernel_ms[1] += sk
        host = wall * 1e3 - t_agu * 1e3 - gk - sk - cp
        print(f"[full] {name} {kw}: bit-exact; epochs={r.stats['epochs']} "
              f"launches gather={g} scatter={s}; wall={wall * 1e3:.1f} ms "
              f"= AGU streams {t_agu * 1e3:.1f} ms (host) + gather kernel "
              f"{gk:.3f} ms + scatter kernel {sk:.3f} ms + H2D/D2H copies "
              f"{cp:.3f} ms (device, profiler) + CU host and launch "
              f"{host:.1f} ms; per launch gather {gk / g * 1e3:.2f} us, "
              f"scatter {sk / s * 1e3:.2f} us; interpreter "
              f"{t_interp * 1e3:.1f} ms")
    return totals, kernel_ms, shapes, args


def phase_line(totals, kernel_ms, shapes, args) -> dict:
    """Time each kernel at the main path's most frequent launch shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.spec_gather import spec_gather
    from repro_torch.kernels.spec_scatter import spec_scatter_add
    out = []
    for i, (name, src, replaces) in enumerate((
            ("spec_gather", "src/repro_torch/kernels/csrc/spec_gather.cu",
             "src/repro/kernels/spec_gather.py:114"),
            ("spec_scatter_add",
             "src/repro_torch/kernels/csrc/spec_scatter.cu",
             "src/repro/kernels/spec_scatter.py:124"))):
        key = max((k for k in shapes if k[0] == name), key=shapes.get)
        a = args[key]
        table, idx = a[0], a[1]
        rows, n, d = key[1], key[2], key[3]
        live = idx >= 0
        n_live = int(live.sum())
        safe = idx.clamp(0, rows - 1).long()
        if name == "spec_gather":
            got = spec_gather(table, idx)
            want = ref.spec_gather(table, idx)
            kern = lambda: spec_gather(table, idx)
            plain = lambda: ref.spec_gather(table, idx)
            lib = lambda: table.index_select(0, safe)
            # index read, live rows read, every output row written
            nbytes = 4 * n + 4 * d * n_live + 4 * d * n
        else:
            values = a[2]
            got = spec_scatter_add(table.clone(), idx, values)
            want = ref.spec_scatter_add(table.clone(), idx, values)
            t2 = table.clone()
            vmask = torch.where(live[:, None], values,
                                torch.zeros_like(values))
            kern = lambda: spec_scatter_add(t2, idx, values)
            plain = lambda: ref.spec_scatter_add(t2, idx, values)
            lib = lambda: t2.index_add_(0, safe, vmask)
            uniq = int(torch.unique(safe[live]).numel())
            # index and live values read, each live destination row read
            # and written once
            nbytes = 4 * n + 4 * d * n_live + 2 * 4 * d * uniq
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() if n else 0.0
        if err != 0.0:
            fail(f"{name} at the main path's shape differs by {err}")
        g0 = spec_gather.launches, spec_scatter_add.launches
        ms, plain_ms, lib_ms = device_ms(kern), device_ms(plain), \
            device_ms(lib)
        eager = call_ms(kern)
        spec_gather.launches, spec_scatter_add.launches = g0
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": totals[i],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": lib_ms,
            "call_ms": eager, "main_path_kernel_ms": kernel_ms[i],
            "shape": {"rows": rows, "n": n, "d": d, "n_live": n_live,
                      "dtype": str(table.dtype).replace("torch.", ""),
                      "share_of_launches": shapes[key] / sum(
                          v for k, v in shapes.items() if k[0] == name)},
        })
    return {"kernels": out}


def main() -> None:
    """Run every phase; print the result lines only if all passed."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    t0 = time.perf_counter()
    phase_build()
    phase_kernels()
    phase_parity()
    line = phase_line(*phase_full())
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
