"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with
``nvcc`` (into ``build/kernels/``), holds each kernel against its plain
PyTorch version on the card, runs every workload of
``repro_torch.bench_irregular`` through ``repro_torch.codegen.run`` on the
card and checks it bit for bit against the port's sequential interpreter,
then runs the full-size codegen path (hist over 2**20 elements, spmv and
sort at n=1024) and times it.  The kernel API's path follows: the
grouped GEMM and the two attention kernels against their plain versions
over an edge sweep in float32 and bfloat16, each call checked to take
the route its wrapper documents (the TMA kernels for aligned bf16, the
tiled kernels otherwise), then each once through
``repro_torch.kernels.ops`` at full model width (Kimi-K2's expert FFN,
Mistral-NeMo-12B's prefill and decode), checked against its plain version
and timed, the tiled bf16 GEMM and flash kernels beside the TMA ones.
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


def main() -> None:
    """Run every phase; print the result lines only if all passed."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    t0 = time.perf_counter()
    phase_build()
    phase_kernels()
    phase_parity()
    line = phase_line(*phase_full())
    phase_kernels_dense()
    line["kernels"] += phase_api_full()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
