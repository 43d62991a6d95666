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
The mesh follows the serving phase (the ninth slice): ``[mesh]`` serves
the same wave again under ``use_mesh`` of a (1, 1) ("data", "model")
mesh on a one-rank NCCL group, where ``moe_spec`` takes the
expert-parallel variant, which must commit the flat run's tokens and
poison count with 17 launches of each bf16 entry; ``[mesh-shards]``
runs the splits one card can hold shard by shard
(``repro_torch.models.moe.run_shards``): Kimi-K2's MoE layer at 4096
tokens expert-parallel at 2 and 4 shards and Grok-1's tensor-parallel
at 2, each against the flat path (poison counts equal, outputs within
``MESH_BF16_TOL``), with the bf16 entries held against their plain
versions and timed at every shard's shapes; ``[dryrun]`` runs one
dry-run cell (Kimi-K2 x decode_32k on a fake 256-rank mesh) in a
subprocess and prints its per-device counts and H100 roofline terms
(its collective term must stay under 1 ms, not the bound: the
sharded decode writes and attends the T-sharded KV cache in place);
``[mesh-attn]``, before it, decodes one Kimi-K2 attention layer at full
width with its cache split 2 and 4 ways over T, shard by shard
(``repro_torch.models.layers.gqa_decode_shards``), against the unsplit
layer (the cache bitwise, the output within ``MESH_BF16_TOL``).
After the parity phase, the ``[sim]`` lines run the paper's evaluation
path: each workload at its default size through
``repro_torch.core.pipeline.run_all`` (STA, DAE, SPEC and ORACLE cycles
of the model machine, not times on any chip), its SPEC pair through the
card, whose final memory must equal the simulated SPEC variant's bit for
bit; pagerank and join compiled cold and warm through the frontend's
compile cache with ``verify=True``, the warm objects run on the card
bitwise; and the soundness verifier's sweeps with mutants, in-process.
After the kernel API, ``[scan]`` holds the SSM scans' kernels
(``repro_torch.kernels.scan``: RWKV-6 and Mamba, forward by each route
and backward) against their plain loops: float32 at a small odd T by the
step routes; the new bf16 routes (RWKV-6 chunked, Mamba chunk) against
the loop run in float32 on the same values at T from 2 to 2048 in three
decay regimes, no further from it than the bf16 loop; then bf16 at one
RWKV-6-7B layer's and one Jamba Mamba layer's shapes: 8 x 512 prefill by
the new route and by the step route on the same inputs, T = 1 decode by
RWKV-6's step route and Mamba's decode route (bitwise the loops) beside
Mamba's step kernel, each timed beside its route's bound, the step-serial
bound and the loop.  The backward follows (the thirteenth slice): the new
chunked backward routes (RWKV-6 ``chunked``,
``csrc/rwkv6_chunk_bwd_sm90.cu``; Mamba ``chunk``, in
``csrc/mamba_scan.cu``) through autograd at full width, B = 2, T from 2
to 2048, and at the shapes ``[train-ssm]`` gives them, in the three
decay regimes, with and without a cotangent of the last state: all six gradients within ``SCAN_GRAD_TOL`` of autograd
through the bf16 loop and ``SCAN_GRAD_F32_TOL`` of the loop in float32;
then at B = 2, T = 2048 the new route and the step pair on the same
inputs, each timed beside the loop, its bound and the step-serial bound,
with the workspace it allocates.
The model families of the seventh slice follow the serving phase, each
first held card against CPU on its float32 smoke config (the same
tokens, logits within 1e-4): ``[ssm]`` serves RWKV-6-7B at full width
and depth through the engine (no spec kernel may launch; the RWKV-6
forward scan once a layer a call: the prefill by the chunked route, the
decode steps by the step route), serves the wave again with
the scans as their plain loops (the same tokens, or a bf16 argmax tie
reported with its logit gap) and profiles the wave with the scans'
kernels apart; ``[hybrid]`` serves one
Jamba-1.5-large group at full width (7 Mamba + 1 attention sublayers,
its four MoE sublayers sharing one expert set to fit the card) through
``dispatch="spec-kernel"`` and ``"spec"``, which must commit the same
tokens and poison counts with 68 launches of each bf16 entry and the
Mamba forward scan once a layer a call (the prefill by the chunk route,
the decode steps by the decode route), against the plain loops as
``[ssm]`` is, profiles
it and holds the bf16 entries to their plain versions at its shapes;
``[cross]`` runs Llama-3.2-Vision-90B (one layer group) and
Whisper-medium (whole) through ``Model.prefill`` / ``decode_step`` with
seeded stub memory, 16 greedy steps, timed and profiled.
Training follows (the eighth slice; of the kernels it reaches only the
scans): ``[train-small]`` runs 3 steps of ``make_train_step`` on every
config's float32 smoke variant on the card and on the CPU from the same
weights (losses within rtol 1e-4, parameters within 1e-4), the rwkv and
jamba configs through the scans' forward and backward kernels (counted),
and checks that a gradient through ``dispatch="spec-kernel"`` and
through each of the five Pallas sites' entries raises on CUDA tensors; ``[train-dense]`` trains Phi-4-mini-3.8B
whole (AdamW) and ``[train-moe]`` one Grok-1-314B group at full width
(``dispatch="spec"``, Adafactor, as the whole model takes it), 2048
tokens a step: step ms, tokens/s, losses, peak memory, the FLOP and
optimizer byte bounds, and a profiled step split into forward, backward
and optimizer by kind of kernel; ``[train-ssm]`` trains RWKV-6-7B at its
published width with 8 of its 32 layers (AdamW, as the whole model
takes it), 2 sequences of 1024 tokens a step, the same lines plus the
scan backward's device time in the profiled step, and fails unless the
backward took the chunked route once a layer a step and no plain loop
was reached; then Jamba's smoke config in bf16 trains 3 steps on the
card through the Mamba chunk backward; ``[train-ckpt]`` saves a bf16 smoke
run on the card asynchronously, restores it bitwise and continues it
through a fresh ``train()``.
Phases print as they finish; the last lines are one
``{"kernels": [...]}`` JSON object, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line is printed.  Without a CUDA device, or outside a checkout, it
exits non-zero at once.
"""
from __future__ import annotations

import collections
import contextlib
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


def call_ms(fn, reps: int = 200, warm: int = 10) -> float:
    """Mean time of one eager ``fn()`` call in ms, CUDA events around
    ``reps`` back-to-back calls after ``warm`` warm-up calls: at the main
    path's sizes this is the host's issue rate (Python, checks, launch),
    not the device's time."""
    for _ in range(warm):
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
    """Tensor-core and TMA instructions in a built library's SASS, and its
    local-memory loads and stores (``LDL``/``STL``: arrays the compiler
    could not keep in registers, and spills) with the kernels that have
    any, or {} without ``cuobjdump``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {op: sass.count(op) for op in ("HGMMA", "HMMA", "UTMALDG")}
    local = {}
    for block in sass.split("Function : ")[1:]:
        n = len(re.findall(r"\b(?:LDL|STL)\b", block))
        if n:
            name = re.search(r"\d\d?((?:rwkv6|mamba|spec|ragged|flash|paged|"
                             r"colsum)\w*?_kernel)", block.split("\n", 1)[0])
            local[name.group(1) if name else block[:40]] = n
    out["LDL/STL"] = sum(local.values())
    out["kernels with local memory"] = local or "none"
    return out


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
# the SSM scans: RWKV-6 and Mamba, forward and backward
# ---------------------------------------------------------------------------

#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), for
#: the step routes' operation bound (step-serial float32 on the CUDA cores)
F32_FLOP_PER_S = 67e12
#: H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet), for the RWKV-6
#: chunked route's operation bound
TF32_FLOP_PER_S = 495e12
#: exps a clock on each SM's special-function units (CUDA C++ Programming
#: Guide, arithmetic instruction throughput, compute capability 9.0) and
#: the H100 SXM's SMs, for the Mamba chunk route's exp bound
SFU_EXP_PER_CLOCK, N_SM = 16, 132
#: the scans' outputs against their plain loops: rtol, and atol as a share
#: of max|want| (the read-out's float32 sum in another order; one bf16 ulp)
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
#: the last state: rtol, and atol as a share of max|want| (the step and
#: decode routes keep the loops' roundings, so it is bitwise unless exp
#: differs)
SCAN_STATE_TOL = 1e-5
#: gradients against autograd through the plain loop, as a share of
#: max|want| (autograd rounds every step's gradient terms to bf16 where
#: the kernels sum them in float32: u's, summed over 2048 steps in bf16,
#: is 0.11 of its max off at the backward's shape)
SCAN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -3}
#: bf16 gradients against autograd through the plain loop in float32 on
#: the same values, as a share of max|want| (the kernels' bf16 roundings
#: of k·v, the read-out's sum and the outputs: about 3e-3 in a CPU
#: emulation of the kernels at T = 512)
SCAN_GRAD_F32_TOL = 2.0 ** -6
#: operations a state element a step (an exp counted as one): RWKV-6
#: forward k·v, u·kv, +, r·M (2), w·S, + ; backward the reverse step's 14
#: and the recomputed S and M's 6; Mamba forward Δ·a, exp, e·s, x·B, +,
#: C·s (2); backward h, dC, dx, dB, g, da, dΔ (2 each), the recomputed
#: exp(Δ·a) (2) and h·e, and the recomputed state's 3.  The step routes'
#: bound, and the old one beside the new routes'.
SCAN_OPS = {("rwkv", False): 7, ("rwkv", True): 20, ("mamba", False): 7,
            ("mamba", True): 22}
#: RWKV-6's head width, Mamba's state width (RWKV-6-7B, Jamba)
SCAN_HD, SCAN_N = 64, 16
#: tokens a chunk of the RWKV-6 chunked route (csrc/rwkv6_chunk_sm90.cu)
SCAN_CHUNK = 16
#: the new routes against the float32 loop: T, and the decay regimes
#: (the models' own; near 0; near 1), at full width, B = 2
SCAN_SWEEP_T = (2, 17, 64, 65, 512, 2048)
SCAN_REGIMES = ("model", "near0", "near1")


def _scan_counters():
    from repro_torch.kernels import scan
    return {"rwkv6_scan": scan.rwkv6_scan, "mamba_scan": scan.mamba_scan}


def _reset_scans() -> None:
    for c in _scan_counters().values():
        c.launches = c.bwd_launches = 0
        c.route_launches = dict.fromkeys(c.route_launches, 0)
        c.bwd_route_launches = dict.fromkeys(c.bwd_route_launches, 0)


def _scan_launches() -> dict:
    """Forward and backward launches of each scan since the last reset."""
    return {n: (c.launches, c.bwd_launches)
            for n, c in _scan_counters().items()}


def _scan_routes() -> dict:
    """Forward launches of each scan by route since the last reset."""
    return {n: dict(c.route_launches) for n, c in _scan_counters().items()}


def _scan_bwd_routes() -> dict:
    """Backward launches of each scan by route since the last reset."""
    return {n: dict(c.bwd_route_launches)
            for n, c in _scan_counters().items()}


@contextlib.contextmanager
def _plain_scans():
    """The models' scans as their plain loops inside the block, on CUDA
    tensors too: the yardstick the kernels' waves are held to."""
    from repro_torch.kernels import ref
    from repro_torch.models import ssm
    saved = ssm._rwkv6_scan, ssm._mamba_scan
    ssm._rwkv6_scan = lambda *a: ref.rwkv6_scan(*a)
    ssm._mamba_scan = lambda *a: ref.mamba_scan(*a)
    try:
        yield
    finally:
        ssm._rwkv6_scan, ssm._mamba_scan = saved


def _scan_args(kind, b, t, width, dtype, gen, regime="model"):
    """Seeded inputs of one scan, made on the card: RWKV-6 at d_model
    ``width`` (heads of 64), Mamba at ``width`` channels (N = 16).  Decays
    and deltas in the ranges the models give them (``regime="model"``:
    w = sigmoid(x + 2), delta = softplus(x - 1)), near 0 (w <= 1e-3, a
    fifth of the channels exactly 0; delta a <= -20) or near 1 (w >=
    0.999 before the bf16 rounding, which takes it to 1 or 0.998; delta a
    >= -1e-3)."""
    dev = torch.device("cuda")

    def f(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    if kind == "rwkv":
        h = width // SCAN_HD
        shape = (b, t, h, SCAN_HD)
        if regime == "model":
            w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)
                              + 2)
        elif regime == "near0":
            w = rand(*shape) * 1e-3
            w[..., ::5] = 0.0
        else:
            w = 1 - rand(*shape) * 1e-3
        return [f(*shape, scale=0.5), f(*shape, scale=0.5), f(*shape),
                w.to(dtype), f(h, SCAN_HD, scale=0.5),
                torch.randn((b, h, SCAN_HD, SCAN_HD), generator=gen,
                            device=dev) * 0.3]
    x = torch.randn((b, t, 1), generator=gen, device=dev)
    if regime == "model":
        delta = torch.nn.functional.softplus(x - 1)
        a = -torch.exp(torch.randn((width, SCAN_N), generator=gen,
                                   device=dev) * 0.5)
    elif regime == "near0":
        delta = torch.nn.functional.softplus(x) + 2
        a = -(10 + 5 * rand(width, SCAN_N))
    else:
        delta = rand(b, t, 1) * 1e-4
        a = -(1 + 9 * rand(width, SCAN_N))
    return [f(b, t, width), delta.to(dtype), f(b, t, SCAN_N),
            f(b, t, SCAN_N), a,
            torch.randn((b, width, SCAN_N), generator=gen, device=dev) * 0.3]


def _scan_bytes(kind, bwd, b, t, width) -> int:
    """Bytes of one scan call at these shapes, bf16 activations: each
    input read once and each output written once (the backward's
    workspace is the kernel's choice, not the function's work)."""
    if kind == "rwkv":
        act, par = b * t * width * 2, width * 2
        state = b * (width // SCAN_HD) * SCAN_HD * SCAN_HD * 4
        fwd = 5 * act + par + 2 * state
        return fwd + (4 * act + par + state if bwd else 0)
    act, small = b * t * width * 2, b * t * (1 + 2 * SCAN_N) * 2
    a, state = width * SCAN_N * 4, b * width * SCAN_N * 4
    fwd = 2 * act + small + a + 2 * state
    return fwd + (act + small + a + state if bwd else 0)


def _sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _scan_bound(kind, route, bwd, b, t, width, clock) -> dict:
    """The least time of one scan call by this route at these shapes: the
    larger of the bytes over 3.35 TB/s and the route's operations over
    their rate.  Step routes (and the backward): :data:`SCAN_OPS` float32
    operations a state element a step at 67 TFLOP/s.  RWKV-6 chunked: the
    chunked form's products at the TF32 rate, 4 hd^2 + 4 C hd a (token,
    head) forward (the state update and read-out, the scores and their
    product with v), 10 hd^2 + 6 C hd backward (the boundary passes' two
    updates, S dy, G v and (k q) G; v.dy, the scores and their product
    with dy).  Mamba chunk: one exp a state element a step on the
    special-function units, forward and backward.  Also the step-serial
    count's bound (``old``) beside every route's, for comparison."""
    nbytes = _scan_bytes(kind, bwd, b, t, width)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    elems = b * t * width * (SCAN_HD if kind == "rwkv" else SCAN_N)
    old_ops = SCAN_OPS[kind, bwd] * elems
    t_old = max(t_bytes, old_ops / F32_FLOP_PER_S * 1e3)
    if route == "chunked":
        per = (10, 6) if bwd else (4, 4)
        ops = elems * per[0] + per[1] * SCAN_CHUNK * b * t * width
        kind_ops = "tf32"
        t_ops = ops / TF32_FLOP_PER_S * 1e3
    elif route == "chunk":
        ops, kind_ops = elems, "sfu exp"
        t_ops = ops / (SFU_EXP_PER_CLOCK * N_SM * clock) * 1e3
    else:
        ops, kind_ops = old_ops, "float32"
        t_ops = ops / F32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": by,
            "bound_kind": "bytes" if by == "bytes" else kind_ops,
            "ops": ops, "bytes": nbytes, "step_serial_bound_ms": t_old}


def _scan_err(tag, got, want, tol) -> float:
    """Max abs error of ``got`` against ``want`` (float32 views); fails
    past rtol ``tol`` with atol ``tol * max|want|``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{tag}: {tuple(got.shape)} {got.dtype} != "
             f"{tuple(want.shape)} {want.dtype}")
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{tag}: non-finite output")
    atol = tol * max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=atol):
        fail(f"{tag}: max abs error {err} past rtol={tol} atol={atol:.3g}")
    return err


def _against_float32(tag, got, args, plain) -> dict:
    """A route that rounds otherwise than the loop, held to the loop run
    in float32 on the same values: state and y finite, each no further
    from it than the bf16 loop's own error.  Returns both errors."""
    want = plain(*[a.float() for a in args])
    loop = plain(*args)
    out = {}
    for g, w, lp, what in zip(got, want, loop, ("state", "y")):
        if not torch.isfinite(g.float()).all():
            fail(f"{tag} {what}: non-finite output")
        err = (g.float() - w).abs().max().item()
        own = (lp.float() - w).abs().max().item()
        if err > own:
            fail(f"{tag} {what}: {err} from the float32 loop, past the bf16 "
                 f"loop's own {own}")
        out[what] = (err, own)
    return out


def _scan_grads(fn, args, seed):
    """The gradients of all six inputs of ``fn``'s scan, given seeded
    cotangents of y and of the last state."""
    return _scan_grads_both(fn, args, seed)[0]


def _scan_cots(s, y, seed):
    """Seeded cotangents of a scan's last state (float32) and of y (y's
    dtype)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w_s = torch.randn(s.shape, generator=g, device="cuda")
    return w_s, torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)


def _scan_grads_both(fn, args, seed):
    """The gradients of all six inputs of ``fn``'s scan from one forward,
    given seeded cotangents of y: with a seeded cotangent of the last
    state, then without one (an input nothing reaches gets zeros)."""
    xs = [a.detach().clone().requires_grad_(True) for a in args]
    s, y = fn(*xs)
    w_s, w_y = _scan_cots(s, y, seed)
    out = []
    for outs, cots in (([s, y], [w_s, w_y]), ([y], [w_y])):
        grads = torch.autograd.grad(outs, xs, cots, allow_unused=True,
                                    retain_graph=not out)
        out.append([torch.zeros_like(x) if gr is None else gr
                    for x, gr in zip(xs, grads)])
    return out


def _scan_kinds():
    from repro_torch.kernels import ref, scan
    return {
        "rwkv": dict(fn=scan.rwkv6_scan, plain=ref.rwkv6_scan,
                     plan=scan.rwkv6_plan, step=scan.rwkv6_scan_fwd,
                     new=scan.rwkv6_chunked_fwd, route="chunked",
                     decode=None, bwd=scan.rwkv6_scan_bwd, width=4096,
                     name="rwkv6_scan", line=66,
                     src="rwkv6_chunk_sm90.cu", bwd_plan=scan.rwkv6_bwd_plan,
                     bwd_new=scan.rwkv6_chunked_bwd,
                     bwd_step=scan.rwkv6_step_bwd, bwd_route="chunked",
                     bwd_src="rwkv6_chunk_bwd_sm90.cu"),
        "mamba": dict(fn=scan.mamba_scan, plain=ref.mamba_scan,
                      plan=scan.mamba_plan, step=scan.mamba_scan_fwd,
                      new=scan.mamba_chunk_fwd, route="chunk",
                      decode=scan.mamba_decode_fwd, bwd=scan.mamba_scan_bwd,
                      width=8192, name="mamba_scan", line=108,
                      src="mamba_scan.cu", bwd_plan=scan.mamba_bwd_plan,
                      bwd_new=scan.mamba_chunk_bwd,
                      bwd_step=scan.mamba_step_bwd, bwd_route="chunk",
                      bwd_src="mamba_scan.cu")}


def _scan_record(k, way, route, src, r) -> dict:
    """One scan route's record of the kernels line (``launches`` filled
    from the main path's phases)."""
    return {"name": f"{k['name']}_{way}_{route}", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/models/ssm.py:{k['line']}",
            "launches": None, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "bound_share": r["bound_ms"] / r["ms"], "scan": k["name"],
            "scan_route": route if way == "fwd" else f"bwd_{route}",
            **{x: r[x] for x in r if x not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}}


def _scan_line(tag, name, b, t, width, r, what) -> None:
    print(f"[scan] {name} {tag} B={b} T={t} width={width}: {what}; "
          f"{r['ms'] * 1e3:.2f} us a launch, plain {r['plain_ms'] * 1e3:.1f} "
          f"us (the loop, eager); bound {r['bound_ms'] * 1e3:.2f} us by "
          f"{r['bound_kind']} ({r['ops'] / 1e9:.3f} G operations, "
          f"{r['bytes'] / 1e6:.1f} MB), {r['bound_ms'] / r['ms']:.1%} of it; "
          f"step-serial bound {r['step_serial_bound_ms'] * 1e3:.2f} us "
          f"({smi()})")


def _kernel_ms(fn, reps: int = 5) -> dict:
    """Device ms a launch of each kernel of ``fn()``, from
    ``torch.profiler`` over ``reps`` calls after one warm-up call: the
    mean over the launches the trace holds (a trace of these calls loses
    some of their kernels now and then, so a sum over it would be short),
    the names shortened to the kernel's own."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = collections.Counter(), collections.Counter()
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU:
            continue
        name = ev.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0].split("::")[-1]
        total[name] += (ev.time_range.end - ev.time_range.start) / 1e3
        count[name] += 1
    return {n: total[n] / count[n] for n, _ in total.most_common()}


def _workspace(fn) -> dict:
    """One ``fn()`` (a backward entry): the device memory it allocated at
    its peak beyond what was allocated before, what it returns, and the
    difference, its workspace (bytes)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    kept = sum(t.numel() * t.element_size() for t in out)
    del out
    return {"peak_bytes": peak, "out_bytes": kept,
            "workspace_bytes": peak - kept}


def _bwd_main_shape(kind) -> tuple:
    """B, T and width of the chunked backward on its main path,
    ``[train-ssm]``: RWKV-6-7B's d_model at :data:`TRAIN_SSM`'s tokens;
    Jamba's smoke config (its d_model is the Mamba channels) at
    :data:`TRAIN_SSM_JAMBA`'s."""
    from repro_torch.configs import base as cbase
    if kind == "rwkv":
        return (TRAIN_SSM["batch"], TRAIN_SSM["seq_len"],
                cbase.get("rwkv6_7b").d_model)
    return (TRAIN_SSM_JAMBA["batch"], TRAIN_SSM_JAMBA["seq_len"],
            cbase.smoke(cbase.get("jamba_1_5_large_398b")).d_model)


def _bwd_sweep(kind, k, gen) -> dict:
    """The new backward route through autograd at B = 2, full width, T in
    :data:`SCAN_SWEEP_T`, and at its main path's shape
    (:func:`_bwd_main_shape`), in every decay regime, with and without a
    cotangent of the last state: all six gradients finite, within
    ``SCAN_GRAD_TOL`` of autograd through the bf16 loop and
    ``SCAN_GRAD_F32_TOL`` of the loop in float32 on the same values (as a
    share of the largest).  Returns the worst shares by regime."""
    bf16, worst = torch.bfloat16, {}
    route = k["bwd_route"]
    shapes = [(2, t, k["width"]) for t in SCAN_SWEEP_T]
    shapes.append(_bwd_main_shape(kind))
    for regime in SCAN_REGIMES:
        w_loop = w_f32 = 0.0
        for b, t, width in shapes:
            args = _scan_args(kind, b, t, width, bf16, gen, regime)
            with torch.no_grad():
                s, y = k["fn"](*args)
            dy = torch.zeros_like(y)
            for ds in (s, None):
                if k["bwd_plan"](*args, ds, dy) != route:
                    fail(f"scan {kind} backward B={b} T={t} width={width}: "
                         f"plan {k['bwd_plan'](*args, ds, dy)}, want {route}")
            del s, y, dy
            n0 = k["fn"].bwd_route_launches[route]
            got = _scan_grads_both(k["fn"], args, 5 + t)
            if k["fn"].bwd_route_launches[route] != n0 + 2:
                fail(f"scan {kind} backward B={b} T={t} width={width}: "
                     f"the {route} route "
                     f"launched {k['fn'].bwd_route_launches[route] - n0} "
                     f"times, want 2")
            for f32, tol in ((False, SCAN_GRAD_TOL[bf16]),
                             (True, SCAN_GRAD_F32_TOL)):
                want = _scan_grads_both(
                    k["plain"], [a.float() for a in args] if f32 else args,
                    5 + t)
                for last, gs, ws in zip(("with", "without"), got, want):
                    for i, (g, w) in enumerate(zip(gs, ws)):
                        tag = (f"scan {kind} {route} backward {regime} B={b} "
                               f"T={t} width={width} {last} ds, gradient "
                               f"{i} against the "
                               f"{'float32' if f32 else 'bf16'} loop")
                        err = _scan_err(tag, g.float(), w.float(), tol)
                        share = err / max(w.float().abs().max().item(),
                                          1e-30)
                        if f32:
                            w_f32 = max(w_f32, share)
                        else:
                            w_loop = max(w_loop, share)
                del want
            del got, args
        worst[regime] = (w_loop, w_f32)
        _free()
    return worst


def _scan_backward(kind, k, gen, clock) -> dict:
    """The backward at B = 2, T = 2048, one layer's width: the new route's
    sweep (:func:`_bwd_sweep`), then the new route and the step pair on
    the same inputs, each timed (CUDA events around eager calls) beside
    the loop (forward and autograd backward through it), its bound, the
    step-serial bound, and the workspace it allocates.  Returns both
    routes' records."""
    bf16, width, name = torch.bfloat16, k["width"], k["name"]
    route = k["bwd_route"]
    t1 = time.perf_counter()
    worst = _bwd_sweep(kind, k, gen)
    print(f"[scan] {name} backward, route {route}, bf16 B=2 width={width}: "
          f"all six gradients finite and within {SCAN_GRAD_TOL[bf16]} of "
          f"autograd through the bf16 loop and {SCAN_GRAD_F32_TOL} of the "
          f"loop in float32 (shares of the largest) at every T in "
          f"{SCAN_SWEEP_T} and at the main path's B, T, width "
          f"{_bwd_main_shape(kind)}, with and without a cotangent of the "
          f"last state; "
          f"worst shares (bf16 loop / float32 loop): " + "; ".join(
              f"{r} {a:.3g} / {b:.3g}" for r, (a, b) in worst.items())
          + f" ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    args = _scan_args(kind, 2, 2048, width, bf16, gen)
    got = _scan_grads(k["fn"], args, 2)
    want = _scan_grads(k["plain"], args, 2)
    errs = [_scan_err(f"scan {kind} backward gradient {i}", g, w,
                      SCAN_GRAD_TOL[bf16])
            for i, (g, w) in enumerate(zip(got, want))]
    rel = [x / w.float().abs().max().item() for x, w in zip(errs, want)]
    # the step pair on the same cotangents, against the same loop
    w_s, w_y = _scan_cots(args[5], args[0], 2)
    errs_step = [_scan_err(f"scan {kind} backward step pair gradient {i}",
                           g, w, SCAN_GRAD_TOL[bf16])
                 for i, (g, w) in enumerate(zip(
                     k["bwd_step"](*args, w_s, w_y), want))]
    del want, w_s, w_y
    want = _scan_grads(k["plain"], [a.float() for a in args], 2)
    rel32 = [_scan_err(f"scan {kind} backward gradient {i} against "
                       f"float32", g.float(), w, SCAN_GRAD_F32_TOL)
             / w.abs().max().item()
             for i, (g, w) in enumerate(zip(got, want))]
    del got, want
    _free()
    g = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        s, y = k["fn"](*args)
    ds = torch.randn(s.shape, generator=g, device="cuda")
    dy = torch.randn(y.shape, generator=g, device="cuda").to(bf16)
    del s, y
    # the step pair (the bf16 loop's roundings) against the new route
    new_g, step_g = k["bwd_new"](*args, ds, dy), k["bwd_step"](*args, ds, dy)
    pair = [_scan_err(f"scan {kind} backward {route} against step, "
                      f"gradient {i}", a.float(), b.float(),
                      SCAN_GRAD_TOL[bf16])
            for i, (a, b) in enumerate(zip(new_g, step_g))]
    del new_g, step_g
    _free()
    plain_ms = call_ms(lambda: _scan_grads(k["plain"], args, 4), reps=1,
                       warm=1)
    out = {}
    for r, fn, reps in ((route, k["bwd_new"], 10), ("step", k["bwd_step"], 3),
                        (route + "_again", k["bwd_new"], 10)):
        ms = call_ms(lambda: fn(*args, ds, dy), reps=reps, warm=1)
        if r.endswith("_again"):
            out[route]["ms_again"] = ms
            continue
        ws = _workspace(lambda: fn(*args, ds, dy))
        _free()
        split = _kernel_ms(lambda: fn(*args, ds, dy))
        _free()
        out[r] = {"ms": ms, "plain_ms": plain_ms, "kernels_ms": split,
                  "max_abs_err": max(errs) if r == route else None,
                  "shape": [2, 2048, width], **ws,
                  **_scan_bound(kind, r, True, 2, 2048, width, clock)}
    out[route].update(grad_max_abs_err=errs, grad_err_share_of_max=rel,
                      grad_err_share_of_max_vs_float32=rel32,
                      sweep_worst_share=worst,
                      vs_step_max_abs_err=pair)
    out["step"].update(max_abs_err=max(errs_step),
                       grad_max_abs_err=errs_step)
    del ds, dy, args
    _free()
    new, step = out[route], out["step"]
    print(f"[scan] {name} backward bf16 B=2 T=2048 width={width}: route "
          f"{route} max abs err vs autograd through the bf16 loop "
          f"{max(errs):.3g} (by input, as a share of max: "
          + ", ".join(f"{x:.2g}" for x in rel)
          + "; against the loop in float32 on the same values: "
          + ", ".join(f"{x:.2g}" for x in rel32) + ")")
    for r, rec in ((route, new), ("step", step)):
        print(f"[scan] {name} backward B=2 T=2048, route {r}: "
              f"{rec['ms'] * 1e3:.2f} us a launch (eager, CUDA events"
              + (f"; again after the step pair {rec['ms_again'] * 1e3:.2f}"
                 if "ms_again" in rec else "")
              + f"), plain {plain_ms * 1e3:.1f} us (forward + autograd "
              f"backward through the loop); bound {rec['bound_ms'] * 1e3:.2f}"
              f" us by {rec['bound_kind']} ({rec['ops'] / 1e9:.3f} G "
              f"operations, {rec['bytes'] / 1e6:.1f} MB), "
              f"{rec['bound_ms'] / rec['ms']:.1%} of it; step-serial bound "
              f"{rec['step_serial_bound_ms'] * 1e3:.2f} us; workspace "
              f"{rec['workspace_bytes'] / 1e9:.4f} GB (peak "
              f"{rec['peak_bytes'] / 1e9:.4f} GB, outputs "
              f"{rec['out_bytes'] / 1e9:.4f} GB); by kernel, us a launch "
              f"(profiled): " + (", ".join(f"{n} {v * 1e3:.1f}" for n, v in
                                           rec["kernels_ms"].items())
                                 or "not captured")
              + f" ({smi()})")
    print(f"[scan] {name} backward B=2 T=2048: route {route} "
          f"{new['ms'] * 1e3:.2f} us, step pair {step['ms'] * 1e3:.2f} us on "
          f"the same inputs, {step['ms'] / new['ms']:.2f}x; workspace "
          f"{new['workspace_bytes'] / 1e9:.4f} GB against "
          f"{step['workspace_bytes'] / 1e9:.4f} GB "
          f"({new['workspace_bytes'] / step['workspace_bytes']:.4f}); the "
          f"two routes' gradients agree within {max(pair):.3g}; "
          f"{time.perf_counter() - t1:.1f} s")
    if step["ms"] < 5 * new["ms"] or \
            16 * new["workspace_bytes"] > step["workspace_bytes"]:
        print(f"[scan] {name} backward: route {route} short of 5x the step "
              f"pair's speed or a sixteenth of its workspace")
    return out


def phase_scan() -> list:
    """The scans' kernels against their plain loops on the card, route by
    route.  First float32 at a small odd shape (T = 37, forward by the
    step routes and backward).  Then the new bf16 routes (RWKV-6
    chunked, Mamba chunk) against the loop run in float32 on the same
    values at T in :data:`SCAN_SWEEP_T` and three decay regimes, at full
    width (B = 2): state and y finite and no further from it than the
    bf16 loop is.  Then the main path's shapes in bf16, one RWKV-6-7B
    layer (64 heads of 64) and one Jamba Mamba layer (8192 channels, N =
    16): prefill (8 x 512) by the new route and by the step route on the
    same inputs, the step route's state bitwise the bf16 loop's; decode
    (T = 1) by RWKV-6's step route and Mamba's decode route, both
    bitwise, beside Mamba's step kernel at T = 1; the backward by the new
    route and by the step pair (:func:`_scan_backward`).  Each timed
    beside its route's bound, the step-serial bound and its plain loop
    (no library call computes the recurrence).  Returns the kernels
    line's records, one a route (``launches`` filled from the main path's
    phases)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(25)
    kinds = _scan_kinds()
    clock = _sm_clock_hz()
    saved = _scan_launches(), {n: (dict(c.route_launches),
                                   dict(c.bwd_route_launches))
                               for n, c in _scan_counters().items()}
    for kind, k in kinds.items():
        args = _scan_args(kind, 2, 37, 256, torch.float32, gen)
        if k["plan"](*args) != "step":
            fail(f"scan {kind} float32: plan {k['plan'](*args)}, want step")
        for got, want, what in zip(k["fn"](*args), k["plain"](*args),
                                   ("state", "y")):
            _scan_err(f"scan {kind} float32 {what}", got, want,
                      SCAN_STATE_TOL if what == "state" else
                      SCAN_TOL[torch.float32])
        for i, (got, want) in enumerate(zip(_scan_grads(k["fn"], args, 1),
                                            _scan_grads(k["plain"], args,
                                                        1))):
            _scan_err(f"scan {kind} float32 gradient {i}", got, want,
                      SCAN_GRAD_TOL[torch.float32])
    print(f"[scan] float32, T = 37 (step routes): both scans' states, "
          f"outputs and the gradients of all six inputs agree with the "
          f"plain loops (rtol {SCAN_STATE_TOL} / {SCAN_TOL[torch.float32]} / "
          f"{SCAN_GRAD_TOL[torch.float32]} of max)")
    bf16 = torch.bfloat16
    t1 = time.perf_counter()
    for kind, k in kinds.items():
        for regime in SCAN_REGIMES:
            errs = []
            for t in SCAN_SWEEP_T:
                args = _scan_args(kind, 2, t, k["width"], bf16, gen, regime)
                if k["plan"](*args) != k["route"]:
                    fail(f"scan {kind} T={t}: plan {k['plan'](*args)}, "
                         f"want {k['route']}")
                got = k["new"](*args)
                e = _against_float32(f"scan {kind} {k['route']} {regime} "
                                     f"T={t}", got, args, k["plain"])
                errs.append((t, e))
                del args, got
            print(f"[scan] {k['name']} {k['route']} bf16 B=2 width="
                  f"{k['width']} {regime}: max abs error against the loop in "
                  f"float32, state / y (the bf16 loop's own): " + "; ".join(
                      f"T={t} {e['state'][0]:.3g} ({e['state'][1]:.3g}) / "
                      f"{e['y'][0]:.3g} ({e['y'][1]:.3g})" for t, e in errs)
                  + "; all finite")
        _free()
    print(f"[scan] the new routes no further from the float32 loop than "
          f"the bf16 loop at every T in {SCAN_SWEEP_T} and decay regime "
          f"({time.perf_counter() - t1:.1f} s)")
    records = []
    b = SERVE["requests"]
    for kind, k in kinds.items():
        width, name = k["width"], k["name"]
        # prefill: the new route and the step route on the same inputs
        args = _scan_args(kind, b, 512, width, bf16, gen)
        plain_ms = call_ms(lambda: k["plain"](*args), reps=2, warm=1)
        got = k["new"](*args)
        e = _against_float32(f"scan {kind} prefill {k['route']}", got, args,
                             k["plain"])
        del got
        new = {"ms": device_ms(lambda: k["new"](*args), reps=50, replays=3),
               "plain_ms": plain_ms, "max_abs_err": e["y"][0],
               "state_max_abs_err": e["state"][0],
               "bf16_loop_err": {"state": e["state"][1], "y": e["y"][1]},
               "err_against": "the loop in float32 on the same bf16 values",
               "shape": [b, 512, width],
               **_scan_bound(kind, k["route"], False, b, 512, width, clock)}
        got, want = k["step"](*args), k["plain"](*args)
        torch.cuda.synchronize()
        bitwise = torch.equal(got[0], want[0])
        err_s = _scan_err(f"scan {kind} prefill step state", got[0], want[0],
                          SCAN_STATE_TOL)
        err = _scan_err(f"scan {kind} prefill step y", got[1], want[1],
                        SCAN_TOL[bf16])
        del got, want
        step = {"ms": device_ms(lambda: k["step"](*args), reps=20,
                                replays=3),
                "plain_ms": plain_ms, "max_abs_err": err,
                "state_max_abs_err": err_s, "state_bitwise": bitwise,
                "shape": [b, 512, width],
                **_scan_bound(kind, "step", False, b, 512, width, clock)}
        _scan_line("prefill, route " + k["route"], name, b, 512, width, new,
                   f"against the loop in float32, state {e['state'][0]:.3g}"
                   f" and y {e['y'][0]:.3g} (the bf16 loop's own "
                   f"{e['state'][1]:.3g} and {e['y'][1]:.3g})")
        _scan_line("prefill, route step", name, b, 512, width, step,
                   f"max abs err vs the bf16 loop {err:.3g} (state "
                   f"{err_s:.3g}, bitwise {bitwise})")
        print(f"[scan] {name} prefill: route {k['route']} "
              f"{new['ms'] * 1e3:.2f} us, route step {step['ms'] * 1e3:.2f} "
              f"us on the same inputs, {step['ms'] / new['ms']:.2f}x")
        del args
        _free()
        # decode: RWKV-6's step route; Mamba's decode route beside its
        # step kernel at T = 1
        args = _scan_args(kind, b, 1, width, bf16, gen)
        plain_ms = call_ms(lambda: k["plain"](*args), reps=50, warm=1)
        want = k["plain"](*args)
        step_y = k["step"](*args)[1]
        decode = {}
        for route, fn in (("decode", k["decode"]), ("step", k["step"])):
            if fn is None:
                continue
            got = fn(*args)
            torch.cuda.synchronize()
            bitwise = torch.equal(got[0], want[0])
            # the decode route: the state bitwise the loop's, y the step
            # kernel's bit for bit (the same sum in the same order)
            if route == "decode" and not (bitwise and torch.equal(got[1],
                                                                  step_y)):
                fail(f"scan {kind} decode route: state bitwise the loop's "
                     f"{bitwise}, y the step kernel's "
                     f"{torch.equal(got[1], step_y)}")
            err_s = _scan_err(f"scan {kind} decode {route} state", got[0],
                              want[0], SCAN_STATE_TOL)
            err = _scan_err(f"scan {kind} decode {route} y", got[1], want[1],
                            SCAN_TOL[bf16])
            decode[route] = {
                "ms": device_ms(lambda: fn(*args), reps=200, replays=3),
                "plain_ms": plain_ms, "max_abs_err": err,
                "state_max_abs_err": err_s, "state_bitwise": bitwise,
                "shape": [b, 1, width],
                **_scan_bound(kind, route, False, b, 1, width, clock)}
            _scan_line(f"decode, route {route}", name, b, 1, width,
                       decode[route], f"max abs err vs the bf16 loop {err:.3g}"
                       f" (state {err_s:.3g}, bitwise {bitwise})")
            del got
        if "decode" in decode:
            print(f"[scan] {name} decode: route decode "
                  f"{decode['decode']['ms'] * 1e3:.2f} us, step kernel "
                  f"{decode['step']['ms'] * 1e3:.2f} us at T = 1, "
                  f"{decode['step']['ms'] / decode['decode']['ms']:.2f}x")
        del args, want, step_y
        _free()
        # backward: the new route and the step pair on the same inputs
        back = _scan_backward(kind, k, gen, clock)
        src = "rwkv6_scan.cu" if kind == "rwkv" else "mamba_scan.cu"
        records.append(_scan_record(k, "fwd", k["route"], k["src"], new))
        if "decode" in decode:
            records.append(_scan_record(k, "fwd", "decode", src,
                                        decode["decode"]))
        records.append(_scan_record(k, "fwd", "step", src,
                                    {**step, "decode": decode["step"]}))
        records.append(_scan_record(k, "bwd", k["bwd_route"], k["bwd_src"],
                                    back[k["bwd_route"]]))
        records.append(_scan_record(k, "bwd", "step", src, back["step"]))
    for n, c in _scan_counters().items():
        c.launches, c.bwd_launches = saved[0][n]
        c.route_launches, c.bwd_route_launches = saved[1][n]
    print(f"[scan] SM clock {clock / 1e9:.3f} GHz (max, nvidia-smi) for the "
          f"exp bound; {time.perf_counter() - t_phase:.1f} s")
    return records


# ---------------------------------------------------------------------------
# the serving path: the model stack and Engine at Kimi-K2's width
# ---------------------------------------------------------------------------

#: the serving phase's traffic: 8 requests of seeded length in [128, 512]
#: (the longest pinned to 512, so the one wave's prefill dispatches
#: 8 x 512 rows), 16 new tokens each, 8 slots, a cache of 544
SERVE = dict(requests=8, prompt=(128, 512), max_new=16, slots=8,
             max_len=544, seed=15)


def _serve_prompts(vocab: int):
    """The serving traffic's prompt lengths and seeded prompts."""
    rng = np.random.default_rng(SERVE["seed"])
    lo, hi = SERVE["prompt"]
    lens = rng.integers(lo, hi + 1, SERVE["requests"])
    lens[int(np.argmax(lens))] = hi
    return lens, [rng.integers(1, vocab, int(n)).astype(np.int32)
                  for n in lens]


def _serve(cfg, params, prompts, dispatch, keep_logits=False):
    """One wave of ``prompts`` through the engine on the card, every model
    call timed (its logits kept when asked); fails on a failed, truncated
    or malformed request."""
    from repro_torch.serve.engine import Engine, Request
    eng = Engine(cfg, params, slots=SERVE["slots"], max_len=SERVE["max_len"],
                 dispatch=dispatch, device=params["embed"].device)
    eng.model = timed = _TimedModel(eng.model, keep_logits)
    reqs = [Request(rid=i, prompt=p, max_new=SERVE["max_new"])
            for i, p in enumerate(prompts)]
    res = eng.run(reqs)
    if any(r.failed or r.truncated for r in reqs) or eng.events:
        fail(f"serve {cfg.name} {dispatch}: events {eng.events}")
    if sorted(res) != list(range(len(prompts))) or any(
            len(v) != SERVE["max_new"] or not all(
                0 <= t < cfg.vocab for t in v) for v in res.values()):
        fail(f"serve {cfg.name} {dispatch}: results {res}")
    return res, eng.wave_stats, timed


class _TimedModel:
    """The engine's model with a host clock around each call (each call
    ends in a device sync: the engine reads its poison count), a check
    that its logits are finite, and the calls' times kept."""

    def __init__(self, model, keep_logits=False):
        self.model = model
        self.prefill_s: list = []
        self.decode_s: list = []
        #: each call's logits on the host, when kept (call i commits
        #: every request's token i)
        self.logits = [] if keep_logits else None

    def _timed(self, fn, into, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"serve.{fn.__name__}"):
            out = fn(*args, **kw)
            torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        if not torch.isfinite(out[0]).all():
            fail("serve: non-finite logits")
        if self.logits is not None:
            self.logits.append(out[0].float().cpu())
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


@contextlib.contextmanager
def _scan_ranges():
    """Wrap the SSM scans in ``ssm.scan`` profiler ranges while the block
    runs, so a profile can tell the recurrences' kernels from the rest."""
    from repro_torch.models import ssm

    def ranged(fn):
        def scan(*args):
            with torch.profiler.record_function("ssm.scan"):
                return fn(*args)
        return scan

    saved = ssm._rwkv6_scan, ssm._mamba_scan
    ssm._rwkv6_scan, ssm._mamba_scan = map(ranged, saved)
    try:
        yield
    finally:
        ssm._rwkv6_scan, ssm._mamba_scan = saved


def _serve_profile(run) -> dict:
    """``run()`` (one more wave) under ``torch.profiler``: for the prefill
    call and the decode steps, the host window, the device's busy time in
    it (the union of kernel and copy intervals), the idle share, busy time
    by kind of kernel, and the top kernels.  Kernels that ran inside the
    device-side span of an ``ssm.scan`` range count as "ssm scan"
    (``scan_ms``, None when the wave ran no scan)."""
    import bisect
    from torch.autograd import DeviceType
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with _scan_ranges(), torch.profiler.profile(activities=act) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    windows = {"prefill": [], "decode_step": []}
    spans = []
    for ev in events:
        span = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CPU:
            if ev.name in ("serve.prefill", "serve.decode_step"):
                windows[ev.name.split(".")[1]].append(span)
        elif ev.name == "ssm.scan":
            spans.append(span)
    spans.sort()
    span_starts = [b for b, _ in spans]

    def in_scan(b, e):
        j = bisect.bisect_right(span_starts, (b + e) / 2) - 1
        return j >= 0 and (b + e) / 2 < spans[j][1]

    # device work: kernels and copies, not the ranges' own annotations
    kernels = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                     for ev in events if ev.device_type != DeviceType.CPU
                     and not ev.name.startswith(("serve.", "ssm.")))
    starts = [k[0] for k in kernels]
    out = {}
    for phase, windows_of in windows.items():
        window = sum(e - b for b, e in windows_of)
        busy = 0.0
        kinds = collections.Counter()
        names = collections.Counter()
        for b, e in windows_of:
            end = b
            # kernels run one at a time: at most one starts before b
            for kb, ke, name in kernels[max(0, bisect.bisect_left(
                    starts, b) - 1):bisect.bisect_left(starts, e)]:
                kb, ke = max(kb, b), min(ke, e)
                if ke <= kb:
                    continue
                kind = "ssm scan" if spans and in_scan(kb, ke) else \
                    _kind(name)
                kinds[kind] += ke - kb
                names[name[:70]] += ke - kb
                busy += max(0.0, ke - max(kb, end))
                end = max(end, ke)
        out[phase] = {
            "calls": len(windows_of), "window_ms": window / 1e3,
            "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / window if window else None,
            "scan_ms": kinds["ssm scan"] / 1e3 if spans else None,
            "by_kind_ms": {k: v / 1e3 for k, v in kinds.most_common()},
            "top_kernels_ms": {k: v / 1e3 for k, v in names.most_common(8)}}
    return out


def _print_profile(tag: str, profile: dict) -> None:
    for phase, pr in profile.items():
        if not pr["busy_ms"]:
            fail(f"{tag}: the profiler saw no device work in {phase}")
        scan = "" if pr["scan_ms"] is None else (
            f"ssm scan {pr['scan_ms']:.2f} ms; ")
        print(f"[{tag}-profile] {phase} ({pr['calls']} calls, profiled): "
              f"window {pr['window_ms']:.2f} ms, device busy "
              f"{pr['busy_ms']:.2f} ms, idle {pr['idle_share']:.1%}; {scan}"
              f"by kind " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      pr["by_kind_ms"].items())
              + " ms; top kernels " + "; ".join(
                  f"{k} {v:.2f}" for k, v in pr["top_kernels_ms"].items())
              + f" ms ({smi()})")


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
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import base as cbase
    from repro_torch.kernels import ref
    from repro_torch.models.model import build_model
    from repro_torch.models.moe import round_capacity as moe_capacity
    _free()
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

    lens, prompts = _serve_prompts(cfg.vocab)

    def serve(dispatch):
        return _serve(cfg, params, prompts, dispatch)

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
    profile = _serve_profile(lambda: serve("spec-kernel"))
    _print_profile("serve", profile)
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
    mesh = phase_mesh(cfg, params, prompts, res_s, waves_s, stats)
    shards = _mesh_shards_kimi(cfg, params)
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
                      "peak_bytes": peak, "prompt_lens": lens.tolist()},
            "mesh": {"serve": mesh, "shards": {
                k: v[name] for k, v in shards.items()}}})
    del params, timed_k, timed_s
    _free()
    return records


# ---------------------------------------------------------------------------
# the mesh: expert- and tensor-parallel MoE dispatch, the dry run
# ---------------------------------------------------------------------------

#: bf16 tolerance of a mesh variant's output against the flat path's:
#: each shard's partial output (EP) or expert output (TP) is rounded to
#: bf16 before the shards are summed, in another order than the flat
#: path's one sum, so the two may differ by a few bf16 rounding steps of
#: the largest output; bounded by 2**-6 * max|flat| (2 ulp at the max)
MESH_BF16_TOL = 2.0 ** -6


def phase_mesh(cfg, params, prompts, res_flat, waves_flat, flat_stats):
    """``[mesh]``: the wave of ``[serve]`` again, through the engine under
    ``use_mesh`` of a (1, 1) ("data", "model") mesh on a one-rank NCCL
    group: ``moe_spec`` takes the expert-parallel variant, whose fill and
    combine launch the bf16 entries and whose partial output and poison
    counts go through NCCL all-reduces.  It must commit the flat run's
    tokens and poison count with 17 launches of each bf16 entry."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import process_group
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh
    t0 = time.perf_counter()
    picked = collections.Counter()
    real_ep = moe._moe_spec_ep

    def ep(*args, **kw):
        picked["ep"] += 1
        return real_ep(*args, **kw)

    with process_group("nccl"):
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        moe._moe_spec_ep = ep
        try:
            with use_mesh(mesh):
                _serve(cfg, params, prompts, "spec-kernel")  # warm-up
                g, s = _counters()
                _reset()
                picked.clear()
                res, waves, timed = _serve(cfg, params, prompts,
                                           "spec-kernel")
                torch.cuda.synchronize()
                launches = {"spec_gather": (
                    g.launches, g.entry_launches["spec_gather_bf16"]),
                    "spec_scatter_add": (
                        s.launches,
                        s.entry_launches["spec_scatter_add_bf16"])}
        finally:
            moe._moe_spec_ep = real_ep
    forwards = 1 + SERVE["max_new"]
    if picked["ep"] != forwards:
        fail(f"mesh: the expert-parallel variant ran {picked['ep']} times, "
             f"want {forwards}")
    for name, (n, bf16) in launches.items():
        if (n, bf16) != (forwards, forwards):
            fail(f"mesh: {name} launched {n} times ({bf16} by the bf16 "
                 f"entry), want {forwards}")
    if res != res_flat:
        fail("mesh: the expert-parallel wave committed other tokens")
    pm = [(w.moe_poison, w.moe_requests) for w in waves]
    pf = [(w.moe_poison, w.moe_requests) for w in waves_flat]
    if pm != pf:
        fail(f"mesh: poison counts {pm} differ from the flat run's {pf}")
    w = waves[0]
    st = {"prefill_ms": timed.prefill_s[0] * 1e3,
          "decode_ms_per_step": float(np.mean(timed.decode_s)) * 1e3,
          "tok_s": w.tokens / w.wall_s, "wall_s": w.wall_s,
          "moe_poison": w.moe_poison, "moe_requests": w.moe_requests,
          "launches": {k: v[0] for k, v in launches.items()}}
    flat = flat_stats["spec-kernel"]
    print(f"[mesh] {cfg.name} one group under use_mesh((1, 1) data x model, "
          f"one-rank NCCL group): expert-parallel MoE in all {forwards} "
          f"forwards, same tokens for all {len(res)} requests and same "
          f"poison as the flat run: {w.moe_poison} of {w.moe_requests} "
          f"dispatch requests poisoned; launches {st['launches']} (bf16 "
          f"entries); prefill {st['prefill_ms']:.2f} ms (flat "
          f"{flat['prefill_ms']:.2f}), decode {st['decode_ms_per_step']:.3f} "
          f"ms a step (flat {flat['decode_ms_per_step']:.3f}), "
          f"{st['tok_s']:.1f} tokens/s (flat {flat['tok_s']:.1f}) "
          f"({time.perf_counter() - t0:.1f} s; {smi()})")
    return st


def _shard_lines(tag, slot, table_rows, d, x, top_k, h):
    """The two bf16 entries at one shard's shapes against their plain
    versions, timed (``_bf16_line``): the scatter of the shard's N*k
    requests into its (rows, d) buffer, the gather of them from ``h``."""
    src = x.repeat_interleave(top_k, dim=0)
    zeros = torch.zeros((table_rows, d), dtype=x.dtype, device=x.device)
    out = {"spec_scatter_add": _bf16_line("spec_scatter_add", slot, zeros,
                                          src),
           "spec_gather": _bf16_line("spec_gather", slot, h, None)}
    del src, zeros
    for name, r in out.items():
        print(f"[mesh-shards] {tag} {name} bf16 n={r['n']} rows={r['rows']} "
              f"live={r['n_live']}: bitwise equal to the plain version; "
              f"device {r['ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library "
              f"{r['library_ms'] * 1e3:.2f} us; byte bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_ms'] / r['ms']:.1%})")
    return out


def _shards_against_flat(tag, variant, p, x, n_shards, cfg, flat, n_flat):
    """``run_shards`` of ``variant`` on the card (each shard's local
    function in turn, launches counted per shard) against the flat path:
    the poisoned count bitwise, the output within MESH_BF16_TOL; then the
    bf16 entries at each shard's shapes."""
    from repro_torch.models import moe
    g, s = _counters()
    per = []

    def each(shard, slot):
        per.append((g.launches, s.launches))

    _reset()
    out, pois, slots = moe.run_shards(
        p, x, n_shards, variant=variant, n_experts=cfg.n_experts,
        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, kernel=True,
        each=each)
    torch.cuda.synchronize()
    gather_total = g.launches
    steps = [(b[0] - a[0], b[1] - a[1])
             for a, b in zip([(0, 0)] + per[:-1], per)]
    want_gather = n_shards if variant == "ep" else 1
    if [st[1] for st in steps] != [1] * n_shards or             gather_total != want_gather:
        fail(f"mesh-shards {tag}: launches per shard {steps}, gathers "
             f"{gather_total} (want one scatter a shard, {want_gather} "
             f"gathers)")
    if int(pois) != int(n_flat):
        fail(f"mesh-shards {tag}: {int(pois)} poisoned, flat {int(n_flat)}")
    dev = (out.float() - flat.float()).abs().max().item()
    bound = MESH_BF16_TOL * flat.float().abs().max().item()
    if not dev <= bound:
        fail(f"mesh-shards {tag}: max |shards - flat| {dev:.4g} past "
             f"{bound:.4g}")
    print(f"[mesh-shards] {tag}: {n_shards} shards summed against flat: "
          f"poisoned {int(pois)} of {x.shape[0] * cfg.top_k} (flat "
          f"{int(n_flat)}, equal); max |shards - flat| {dev:.4g} (bound "
          f"{bound:.4g} = 2**-6 max|flat|); launches per shard (gather, "
          f"scatter) {steps}, gathers in all {gather_total}")
    rec = {"n_shards": n_shards, "poisoned": int(pois),
           "max_abs_dev": dev, "bound": bound, "launches": steps,
           "kernels": []}
    d = x.shape[1]
    cap = moe.round_capacity(x.shape[0], cfg.n_experts, cfg.top_k,
                             cfg.capacity_factor)
    e_rows = (cfg.n_experts // n_shards if variant == "ep"
              else cfg.n_experts) * cap
    kgen = torch.Generator(device="cuda").manual_seed(23)
    h = torch.randn((e_rows, d), generator=kgen, device="cuda").bfloat16()
    for shard, slot in enumerate(slots if variant == "ep" else slots[:1]):
        rec["kernels"].append(_shard_lines(
            f"{tag} shard {shard}", slot, e_rows, d, x, cfg.top_k, h))
    del h, out, slots
    return rec


def _skewed_tokens(n: int, d: int, gen) -> torch.Tensor:
    """``n`` bf16 activations of width ``d`` that share one random
    component as large as their own, so the router favours the same
    experts and the capacity race poisons requests."""
    x = torch.randn((n, d), generator=gen, device="cuda")
    x += torch.randn((1, d), generator=gen, device="cuda")
    return x.bfloat16()


def _mesh_shards_kimi(cfg, params) -> dict:
    """``[mesh-shards]``, Kimi-K2's MoE layer at the prefill shape (4096
    tokens): the expert-parallel split at 2 and 4 shards against flat."""
    from repro_torch.models import moe
    t0 = time.perf_counter()
    p = params["groups"][0]["s1_moe"]
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = _skewed_tokens(4096, cfg.d_model, gen)
    flat, n_flat = moe._moe_spec_flat(
        p, x, n_experts=cfg.n_experts, top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor, kernel=True, stats=True)
    out = {}
    for n in (2, 4):
        rec = _shards_against_flat(f"{cfg.name} EP x{n}", "ep", p, x, n,
                                   cfg, flat, n_flat)
        out[f"ep{n}"] = {
            name: {**{k: v for k, v in rec.items() if k != "kernels"},
                   "per_shard": [kr[name] for kr in rec["kernels"]]}
            for name in ("spec_gather", "spec_scatter_add")}
    print(f"[mesh-shards] {cfg.name} done ({time.perf_counter() - t0:.1f} "
          f"s; {smi()})")
    del x, flat
    return out


def phase_mesh_shards_grok() -> dict:
    """``[mesh-shards]``, Grok-1's MoE layer (8 experts, ff 32768) at 4096
    tokens: the tensor-parallel split at 2 shards against flat."""
    from repro_torch.configs import base as cbase
    from repro_torch.models import moe
    from repro_torch.models.model import init_sublayer
    _free()
    t0 = time.perf_counter()
    cfg = cbase.get("grok_1_314b")
    gen = torch.Generator(device="cuda").manual_seed(22)
    p = init_sublayer(cfg, "moe", gen, torch.device("cuda"))
    x = _skewed_tokens(4096, cfg.d_model, gen)
    flat, n_flat = moe._moe_spec_flat(
        p, x, n_experts=cfg.n_experts, top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor, kernel=True, stats=True)
    rec = _shards_against_flat(f"{cfg.name} TP x2", "tp", p, x, 2, cfg,
                               flat, n_flat)
    print(f"[mesh-shards] {cfg.name} done ({time.perf_counter() - t0:.1f} "
          f"s; {smi()})")
    del p, x, flat
    _free()
    return {name: {**{k: v for k, v in rec.items() if k != "kernels"},
                   "per_shard": [kr[name] for kr in rec["kernels"]]}
            for name in ("spec_gather", "spec_scatter_add")}


#: ``[mesh-attn]``: requests and cache positions of the decode
MESH_ATTN = dict(batch=8, t_max=32768, seed=24, reps=10)


def phase_mesh_attn() -> dict:
    """``[mesh-attn]``: one Kimi-K2 attention layer at full width (64
    query heads, 8 K/V heads of 112) decodes against a bf16 KV cache of
    8 requests x 32,768 positions split 2 and 4 ways over T, shard by
    shard on the card (``repro_torch.models.layers.gqa_decode_shards``:
    each shard writes its positions of the new keys and values, and
    ``layers.seq_parallel``, the function the mesh runs, combines the
    shards' row max, exponentials' sum and partial contexts in shard
    order, where the mesh all-reduces them), against the unsplit layer:
    the cache bitwise, the output within ``MESH_BF16_TOL``.  Two steps: 2
    tokens at T/2 - 1 (across a shard boundary of both splits), then 1
    at T/2 + 1.  Each shard's work in the one-token step (what one rank
    of the mesh runs: its write, then ``seq_parallel`` on its one shard,
    the reductions across cards left out) is timed with CUDA events
    around it (synchronised first, so launch gaps count)."""
    from repro_torch.configs import base as cbase
    from repro_torch.models import layers as L
    from repro_torch.models.model import init_sublayer
    _free()
    t0 = time.perf_counter()
    cfg = cbase.get("kimi_k2_1t_a32b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(MESH_ATTN["seed"])
    p = init_sublayer(cfg, "attn", gen, dev)
    b, tmax = MESH_ATTN["batch"], MESH_ATTN["t_max"]
    filled = tmax // 2 - 1
    ck, cv = (torch.zeros((b, cfg.n_kv_heads, tmax, cfg.hd),
                          dtype=torch.bfloat16, device=dev)
              for _ in range(2))
    for c in (ck, cv):
        c[:, :, :filled] = torch.randn(
            (b, cfg.n_kv_heads, filled, cfg.hd), generator=gen,
            device=dev).bfloat16()
    pad = torch.randint(0, 64, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    steps = ((2, filled), (1, filled + 2))
    xs = [torch.randn((b, t, cfg.d_model), generator=gen,
                      device=dev).bfloat16() for t, _ in steps]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, theta=cfg.rope_theta, pad_len=pad)

    def timed(fn):
        """``fn``'s device time, µs, the mean of ``reps`` runs after one
        warm-up."""
        fn()
        spent = 0.0
        for _ in range(MESH_ATTN["reps"]):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            spent += start.elapsed_time(stop) * 1e3
        return spent / MESH_ATTN["reps"]

    flat_kv = (ck.clone(), cv.clone())
    flat = [L.gqa_attention(p, x, pos_offset=cl, kv_cache=flat_kv,
                            cache_len=cl, **kw)[0]
            for x, (_, cl) in zip(xs, steps)]
    x1, (_, cl1) = xs[1], steps[1]
    flat_us = timed(lambda: L.gqa_attention(
        p, x1, pos_offset=cl1, kv_cache=flat_kv, cache_len=cl1, **kw))
    q1, k1, v1 = L._self_qkv(p, x1, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                             cfg.rope_theta, cl1, pad)

    def one_shard(kv, lo, n):
        """One rank's work on the shard of ``n`` positions from ``lo``."""
        cks, cvs = (c[:, :, lo:lo + n] for c in kv)
        L._shard_write(cks, k1, cl1, lo)
        L._shard_write(cvs, v1, cl1, lo)
        return L.seq_parallel(q1, [cks], [cvs], [lo], cl1 + 1, pad,
                              lambda parts, op: parts[0])

    rec = {"batch": b, "t_max": tmax, "steps": [list(st) for st in steps],
           "flat_us": flat_us, "splits": {}}
    for n in (2, 4):
        kv = (ck.clone(), cv.clone())
        outs = [L.gqa_decode_shards(p, x, kv_cache=kv, cache_len=cl,
                                    n_shards=n, **kw)[0]
                for x, (_, cl) in zip(xs, steps)]
        torch.cuda.synchronize()
        if not (torch.equal(kv[0], flat_kv[0])
                and torch.equal(kv[1], flat_kv[1])):
            fail(f"mesh-attn: the cache split {n} ways differs from the "
                 f"unsplit layer's")
        devs, bounds = [], []
        for got, want in zip(outs, flat):
            devs.append((got.float() - want.float()).abs().max().item())
            bounds.append(MESH_BF16_TOL * want.float().abs().max().item())
            if not devs[-1] <= bounds[-1]:
                fail(f"mesh-attn: {n} shards, max |shards - flat| "
                     f"{devs[-1]:.4g} past {bounds[-1]:.4g}")
        shard_us = {i: timed(lambda i=i: one_shard(kv, i * tmax // n,
                                                   tmax // n))
                    for i in range(n)}
        rec["splits"][n] = {"max_abs_dev": devs, "bound": bounds,
                            "shard_us": shard_us}
        print(f"[mesh-attn] {cfg.name} attention, KV cache {b} x "
              f"{cfg.n_kv_heads} x {tmax} x {cfg.hd} bf16 split {n} ways "
              f"over T, shard by shard: cache bitwise equal to the unsplit "
              f"layer's after writes at {steps[0][1]}..{steps[0][1] + 1} "
              f"(across a shard boundary) and {steps[1][1]}; max |shards - "
              f"flat| {', '.join(f'{d:.4g}' for d in devs)} (bounds "
              f"{', '.join(f'{x:.4g}' for x in bounds)} = 2**-6 max|flat|); "
              f"one-token step, each shard's write, scores and context "
              f"{', '.join(f'{u:.1f}' for u in shard_us.values())} us "
              f"(unsplit layer {flat_us:.1f} us, with its projections)")
        del kv, outs
    print(f"[mesh-attn] done ({time.perf_counter() - t0:.1f} s; {smi()})")
    del p, ck, cv, flat_kv, flat
    _free()
    return rec


DRYRUN_CELL = ("kimi_k2_1t_a32b", "decode_32k")


def phase_dryrun() -> dict:
    """``[dryrun]``: one dry-run cell in its own process (a fake process
    group of 256 ranks, the (16, 16) production mesh, fake tensors: no
    device memory), its per-device counts and the H100 roofline terms."""
    from repro_torch.launch import roofline
    arch, shape = DRYRUN_CELL
    out = os.path.join(ROOT, "build", "dryrun", f"{arch}__{shape}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--out", out],
                       capture_output=True, text=True, env=env, timeout=600,
                       cwd=ROOT)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        fail(f"dryrun {arch} x {shape}: exit {p.returncode}\n"
             f"{p.stderr[-3000:]}")
    with open(out) as fh:
        rec = json.load(fh)
    r = roofline.analyze(rec)
    mem = rec["memory_analysis"]
    coll = rec["collective_bytes"]
    print(f"[dryrun] {arch} x {shape} x single ({rec['n_devices']} fake "
          f"ranks, (16, 16) data x model, no device memory): per device "
          f"parameters {rec['param_bytes'] / 1e9:.3f} GB, arguments "
          f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, outputs "
          f"{mem['output_size_in_bytes'] / 1e9:.3f} GB (in place "
          f"{mem['alias_size_in_bytes'] / 1e9:.3f}), live-output peak "
          f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB; matmul FLOPs "
          f"{rec['flops']:.6g}, matmul bytes {rec['bytes_accessed']:.6g}; "
          f"collective bytes " + ", ".join(
              f"{k} {v:.6g}" for k, v in coll.items())
          + f"; replicated ops {rec['replicated_ops']}; cell "
          f"{rec['seconds']:.1f} s in a {wall:.1f} s process")
    print(f"[dryrun] H100 roofline (989 TFLOP/s bf16, 3.35 TB/s HBM3, "
          f"450 GB/s NVLink a direction): compute {r.compute_s * 1e3:.4f} "
          f"ms, memory {r.memory_s * 1e3:.4f} ms, collective "
          f"{r.collective_s * 1e3:.4f} ms; {r.dominant}-bound, step bound "
          f"{r.step_time_s * 1e3:.4f} ms, useful {r.useful_ratio:.3f}, MFU "
          f"at the bound {r.mfu:.2%} (counted work, not a time measured "
          f"on a card)")
    if not (rec["flops"] > 0 and coll["total"] > 0):
        fail(f"dryrun: nothing counted: {rec}")
    if r.collective_s >= 1e-3 or r.dominant == "collective":
        fail(f"dryrun: collective term {r.collective_s * 1e3:.4f} ms "
             f"({r.dominant}-bound): the sharded decode gathers what the "
             f"reference keeps sharded")
    return {"record": {k: v for k, v in rec.items()}, "roofline":
            {"compute_s": r.compute_s, "memory_s": r.memory_s,
             "collective_s": r.collective_s, "dominant": r.dominant,
             "step_time_s": r.step_time_s, "mfu": r.mfu},
            "wall_s": wall}


# ---------------------------------------------------------------------------
# the ssm, hybrid, vlm and encdec families at full width
# ---------------------------------------------------------------------------

#: float32 smoke-config checks, card against CPU (tests/test_kernels.py's
#: model tolerance)
SMOKE_TOL = 1e-4


def _greedy(model, params, tokens, steps, memory=None, dec_memory=None,
            pad_lens=None):
    """Prefill, then ``steps`` greedy decode steps: every call's logits
    and the committed tokens.  ``dec_memory`` is what the decode steps
    cross-attend to (the enc-dec family's memory encoded once)."""
    max_len = tokens.shape[1] + steps + 1
    logits, cache = model.prefill(params, tokens, max_len, memory=memory,
                                  pad_lens=pad_lens)
    out, toks = [logits], []
    for step in range(steps):
        toks.append(logits.argmax(-1)[:, None].to(torch.int32))
        logits, cache = model.decode_step(
            params, cache, toks[-1], tokens.shape[1] + step,
            memory=dec_memory, pad_lens=pad_lens)
        out.append(logits)
    toks.append(logits.argmax(-1)[:, None].to(torch.int32))
    return out, torch.cat(toks, 1)


def _stub_memory(cfg, b, gen, device, dtype):
    """Seeded stub patch (vlm) or frame (encdec) embeddings, or None."""
    if cfg.family not in ("vlm", "encdec"):
        return None
    s = cfg.enc_len if cfg.family == "encdec" else cfg.n_patches
    return torch.randn((b, s, cfg.d_model), generator=gen,
                       device=device).to(dtype)


def _small_family_agrees(arch: str, dispatch: str) -> None:
    """The family's float32 smoke config through the same prefill and
    greedy decode calls on the card and on the CPU, left-padded, with stub
    memory where the family takes it: the same tokens, logits within
    ``SMOKE_TOL``."""
    from torch.utils._pytree import tree_map
    from repro_torch.configs import base as cbase
    from repro_torch.models.model import build_model
    cfg = cbase.smoke(cbase.get(arch))
    m = build_model(cfg, dispatch)
    params = m.init(torch.Generator().manual_seed(5), "cpu")
    rng = np.random.default_rng(5)
    tok = torch.from_numpy(rng.integers(1, cfg.vocab, (3, 9)).astype(
        np.int32))
    pads = torch.tensor([0, 3, 5], dtype=torch.int32)
    mem = _stub_memory(cfg, 3, torch.Generator().manual_seed(6), "cpu",
                       torch.float32)
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        mdev = None if mem is None else mem.to(dev)
        dec = m._encode(p, mdev) if cfg.family == "encdec" else mdev
        logits, toks = _greedy(m, p, tok.to(dev), 6, mdev, dec,
                               pads.to(dev))
        runs[dev] = ([x.cpu() for x in logits], toks.cpu())
    if not torch.equal(runs["cpu"][1], runs["cuda"][1]):
        fail(f"{arch} smoke: tokens differ cuda/cpu: {runs}")
    err = max((a - b).abs().max().item()
              for a, b in zip(runs["cpu"][0], runs["cuda"][0]))
    for a, b in zip(runs["cpu"][0], runs["cuda"][0]):
        if not torch.allclose(b, a, atol=SMOKE_TOL, rtol=SMOKE_TOL):
            fail(f"{arch} smoke: logits differ cuda/cpu by {err}")
    print(f"[{cfg.family}] {arch} smoke config (float32, dispatch="
          f"{dispatch}): prefill + 6 greedy steps on the card commit the "
          f"CPU's tokens, logits within {SMOKE_TOL} (max |diff| {err:.3g})")


def _weights_line(tag, cfg, params, t0, cut) -> None:
    """Parameter count and bytes (shared tensors once) of ``params``."""
    from torch.utils._pytree import tree_leaves
    leaves = {t.data_ptr(): t for t in tree_leaves(params)}.values()
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"[{tag}] {cfg.name} at full width ({cut}): d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; {n / 1e9:.2f}e9 "
          f"parameters, {nbytes / 1e9:.2f} GB, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")


def _wave_line(tag, dispatch, plen, waves, timed, peak=None) -> dict:
    w = waves[0]
    st = {"wall_s": w.wall_s, "prefill_ms": timed.prefill_s[0] * 1e3,
          "decode_ms_per_step": float(np.mean(timed.decode_s)) * 1e3,
          "decode_steps": len(timed.decode_s), "tok_s": w.tokens / w.wall_s,
          "peak_bytes": peak}
    mem = "" if peak is None else f"; peak device memory {peak / 1e9:.2f} GB"
    print(f"[{tag}] dispatch={dispatch}: prefill {st['prefill_ms']:.2f} ms "
          f"({SERVE['requests']} x {plen} rows); decode "
          f"{st['decode_ms_per_step']:.3f} ms a step ({st['decode_steps']} "
          f"steps); wave {w.wall_s * 1e3:.1f} ms, {w.tokens} tokens, "
          f"{st['tok_s']:.1f} tokens/s{mem} ({smi()})")
    return st


def _free() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _n_sublayers(params, kind: str) -> int:
    """Sublayers of ``kind`` in a parameter tree (keys ``s{j}_{kind}``)."""
    return sum(k.endswith(f"_{kind}") for g in params["groups"] for k in g)


def _check_scans(tag: str, want: dict, routes: dict,
                 bwd_routes: dict = None) -> None:
    """Fail unless the scans' (forward, backward) launches since the last
    :func:`_reset_scans` are ``want``, their forward launches by route
    ``routes`` and their backward ones ``bwd_routes`` (names and routes
    not given: none)."""
    want = {n: want.get(n, (0, 0)) for n in _scan_counters()}
    if _scan_launches() != want:
        fail(f"{tag}: scan launches (forward, backward) {_scan_launches()}, "
             f"want {want}")
    full = {n: {**dict.fromkeys(c.route_launches, 0), **routes.get(n, {})}
            for n, c in _scan_counters().items()}
    if _scan_routes() != full:
        fail(f"{tag}: scan launches by route {_scan_routes()}, want {full}")
    full = {n: {**dict.fromkeys(c.bwd_route_launches, 0),
                **(bwd_routes or {}).get(n, {})}
            for n, c in _scan_counters().items()}
    if _scan_bwd_routes() != full:
        fail(f"{tag}: scan backward launches by route {_scan_bwd_routes()}, "
             f"want {full}")


def _same_tokens(tag, res_k, res_p, timed_k, timed_p) -> dict:
    """The kernels' wave against the plain loops' wave (both with kept
    logits): the same tokens, or the same up to the first step where a
    request's argmax flips between two tokens whose plain logits differ
    by no more than twice the two runs' largest logit difference on that
    row (a bf16 tie); later steps then take other inputs and are not
    compared.  Fails on any other difference."""
    first = next((s for s in range(SERVE["max_new"]) if any(
        res_k[i][s] != res_p[i][s] for i in res_p)), None)
    if first is None:
        return {"equal": True, "flips": []}
    flips = []
    lk, lp = timed_k.logits[first], timed_p.logits[first]
    for i in sorted(res_p):
        tk, tp = res_k[i][first], res_p[i][first]
        if tk == tp:
            continue
        gap = (lp[i, tp] - lp[i, tk]).item()
        dev = (lk[i] - lp[i]).abs().max().item()
        flips.append({"request": i, "step": first, "kernel_token": tk,
                      "plain_token": tp, "logit_gap": gap,
                      "logit_dev": dev})
        if gap > 2 * dev:
            fail(f"{tag}: request {i} step {first}: token {tk} (kernels) "
                 f"against {tp} (plain loops), plain logit gap {gap} past "
                 f"twice the runs' logit difference {dev}")
    return {"equal": False, "flips": flips}


def _tokens_line(same: dict) -> str:
    if same["equal"]:
        return (f"the kernels commit the plain loops' tokens for all "
                f"{SERVE['requests']} requests and {SERVE['max_new']} steps")
    return ("bf16 argmax ties flip: " + "; ".join(
        f"request {f['request']} at step {f['step']} takes {f['kernel_token']}"
        f" (plain {f['plain_token']}), plain logit gap {f['logit_gap']:.4g} "
        f"within twice the runs' logit difference {f['logit_dev']:.4g}"
        for f in same["flips"]) + f"; every earlier step equal")


def phase_ssm() -> dict:
    """RWKV-6-7B at full width and full depth (nothing cut) served by the
    engine: one wave of the serving traffic, timed, checked to launch no
    spec kernel (the family has no MoE) and the RWKV-6 forward scan once
    a layer a call, then the same wave with the scans as their plain loops
    (the tokens held to the kernels' wave, the loops' times beside), then
    profiled with the scans' kernels apart from the projections'.  Returns
    the forward scan's launches a wave and the wave's numbers."""
    from repro_torch.configs import base as cbase
    from repro_torch.models.model import build_model
    _free()
    _small_family_agrees("rwkv6_7b", "spec")
    cfg = cbase.get("rwkv6_7b")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SERVE["seed"]), dev)
    torch.cuda.synchronize()
    _weights_line("ssm", cfg, params, t0,
                  f"all {cfg.n_layers} layers, {cfg.d_model // cfg.hd} "
                  f"rwkv heads of {cfg.hd}")
    n_rwkv = _n_sublayers(params, "rwkv")
    lens, prompts = _serve_prompts(cfg.vocab)
    _serve(cfg, params, prompts, "spec")  # warm-up
    _reset()
    _reset_scans()
    res, waves, timed = _serve(cfg, params, prompts, "spec", keep_logits=True)
    torch.cuda.synchronize()
    if _launches() != (0, 0):
        fail(f"ssm: spec kernels launched {_launches()} times")
    calls = 1 + len(timed.decode_s)
    # the bf16 prefill by the chunked route, the T = 1 steps by the step one
    routes = {"rwkv6_scan": {"chunked": n_rwkv,
                             "step": n_rwkv * (calls - 1)}}
    _check_scans("ssm", {"rwkv6_scan": (n_rwkv * calls, 0)}, routes)
    stats = _wave_line("ssm", "spec", int(lens.max()), waves, timed,
                       torch.cuda.max_memory_allocated())
    with _plain_scans():
        res_p, waves_p, timed_p = _serve(cfg, params, prompts, "spec",
                                         keep_logits=True)
    plain = _wave_line("ssm", "spec, the scans as plain loops",
                       int(lens.max()), waves_p, timed_p)
    same = _same_tokens("ssm", res, res_p, timed, timed_p)
    print(f"[ssm] {_tokens_line(same)}; rwkv6_scan forward launched "
          f"{n_rwkv * calls} times ({n_rwkv} layers x {calls} calls; by "
          f"route {routes['rwkv6_scan']}); "
          f"prefill {plain['prefill_ms'] / stats['prefill_ms']:.1f}x and "
          f"decode {plain['decode_ms_per_step'] / stats['decode_ms_per_step']:.1f}x "
          f"faster than the loops")
    del timed, timed_p
    t0 = time.perf_counter()
    _reset_scans()
    profile = _serve_profile(lambda: _serve(cfg, params, prompts, "spec"))
    _check_scans("ssm-profile", {"rwkv6_scan": (n_rwkv * calls, 0)}, routes)
    _print_profile("ssm", profile)
    print(f"[ssm] no spec kernel launched; {len(res)} requests, prompt "
          f"lengths {sorted(int(n) for n in lens)}; profile "
          f"{time.perf_counter() - t0:.1f} s")
    del params
    _free()
    return {"launches": n_rwkv * calls, "routes": routes["rwkv6_scan"],
            "stats": stats, "plain": plain, "tokens": same,
            "profile": profile}


def jamba_group_params(cfg, gen, device):
    """Jamba's one layer group with every weight drawn by the model's own
    ``init_sublayer``, except that the group's MoE sublayers share one set
    of expert weights (``w_gate``, ``w_up``, ``w_down``): four distinct
    sets do not fit in 80 GB.  Routers, norms and every other weight stay
    distinct; each sublayer still reads its experts from device memory,
    so a step moves the untied group's bytes."""
    import dataclasses
    from repro_torch.models.model import draw_dense, group_pattern, \
        init_sublayer
    dt = cfg.torch_dtype
    params = {"embed": draw_dense((cfg.vocab, cfg.d_model), gen, device,
                                  dt),
              "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=device)}
    group, experts = {}, None
    for j, kind in enumerate(group_pattern(cfg)):
        if kind == "moe" and experts is not None:
            # the router and norm alone: a one-wide expert draw, replaced
            p = init_sublayer(dataclasses.replace(cfg, moe_d_ff=1), kind,
                              gen, device)
            p.update(experts)
        else:
            p = init_sublayer(cfg, kind, gen, device)
            if kind == "moe":
                experts = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
        group[f"s{j}_{kind}"] = p
    params["groups"] = [group]
    params["lm_head"] = draw_dense((cfg.d_model, cfg.vocab), gen, device,
                                   dt)
    return params


def phase_hybrid() -> dict:
    """Jamba-1.5-large at full width, one layer group of 8 (7 mamba + 1
    attention, MoE on every second sublayer, the MoE sublayers' experts
    shared), served by the engine through dispatch="spec-kernel" (its
    launches counted: 4 MoE forwards a call, the Mamba forward scan once
    a layer a call) and "spec", which must commit the same tokens and
    poison counts; the spec-kernel wave again with the scans as their
    plain loops, held to the kernels' tokens; profiled; then the two bf16
    entries held against their plain versions at Jamba's prefill and
    decode shapes.  Returns the entries' launches and lines, and the
    Mamba scan's launches and token comparison."""
    import dataclasses
    from repro_torch.configs import base as cbase
    from repro_torch.models.model import group_pattern
    from repro_torch.models.moe import round_capacity as moe_capacity
    _free()
    _small_family_agrees("jamba_1_5_large_398b", "spec-kernel")
    full = cbase.get("jamba_1_5_large_398b")
    cfg = dataclasses.replace(full, n_layers=full.attn_stride)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = jamba_group_params(
        cfg, torch.Generator(device=dev).manual_seed(SERVE["seed"]), dev)
    torch.cuda.synchronize()
    n_moe = group_pattern(cfg).count("moe")
    _weights_line("hybrid", cfg, params, t0,
                  f"n_layers {full.n_layers} cut to {cfg.n_layers}: one "
                  f"group of 7 mamba + 1 attention, {cfg.n_heads} heads, "
                  f"{cfg.n_kv_heads} KV heads, {n_moe} MoE sublayers of "
                  f"{cfg.n_experts} experts top-{cfg.top_k} sharing one "
                  f"expert set")
    lens, prompts = _serve_prompts(cfg.vocab)
    plen = int(lens.max())
    n_mamba = _n_sublayers(params, "mamba")
    _serve(cfg, params, prompts, "spec-kernel")  # warm-up
    g, s = _counters()
    _reset()
    _reset_scans()
    res_k, waves_k, timed_k = _serve(cfg, params, prompts, "spec-kernel",
                                     keep_logits=True)
    torch.cuda.synchronize()
    calls = 1 + len(timed_k.decode_s)
    # the bf16 prefill by the chunk route, the T = 1 steps by decode
    scan_routes = {"mamba_scan": {"chunk": n_mamba,
                                  "decode": n_mamba * (calls - 1)}}
    _check_scans("hybrid", {"mamba_scan": (n_mamba * calls, 0)},
                 scan_routes)
    launches = {"spec_gather": (g.launches, dict(g.route_launches),
                                g.entry_launches["spec_gather_bf16"]),
                "spec_scatter_add": (s.launches, dict(s.route_launches),
                                     s.entry_launches[
                                         "spec_scatter_add_bf16"])}
    peak = torch.cuda.max_memory_allocated()
    res_s, waves_s, timed_s = _serve(cfg, params, prompts, "spec")
    torch.cuda.synchronize()
    if (g.launches, s.launches) != (launches["spec_gather"][0],
                                    launches["spec_scatter_add"][0]):
        fail("hybrid: dispatch='spec' launched a spec kernel")
    want = n_moe * (1 + SERVE["max_new"])
    for name, (n, routes, bf16) in launches.items():
        if n != want or bf16 != want or routes != {"tensor": want,
                                                   "staged": 0}:
            fail(f"hybrid: {name} launched {n} times (by route {routes}, "
                 f"bf16 entry {bf16}), want {want}: {n_moe} MoE sublayers "
                 f"x (1 prefill + {SERVE['max_new']} decode steps)")
    if res_k != res_s:
        fail(f"hybrid: spec-kernel tokens {res_k} != spec tokens {res_s}")
    pk = [(w.moe_poison, w.moe_requests) for w in waves_k]
    if pk != [(w.moe_poison, w.moe_requests) for w in waves_s] or \
            len(waves_k) != 1:
        fail(f"hybrid: waves or poison counts differ: {pk} vs "
             f"{[(w.moe_poison, w.moe_requests) for w in waves_s]}")
    cap_p = moe_capacity(SERVE["requests"] * plen, cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
    cap_d = moe_capacity(SERVE["requests"], cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
    stats = {"spec-kernel": _wave_line("hybrid", "spec-kernel", plen,
                                       waves_k, timed_k, peak),
             "spec": _wave_line("hybrid", "spec", plen, waves_s, timed_s)}
    with _plain_scans():
        res_p, waves_p, timed_p = _serve(cfg, params, prompts,
                                         "spec-kernel", keep_logits=True)
    stats["plain"] = _wave_line("hybrid",
                                "spec-kernel, the scans as plain loops",
                                plen, waves_p, timed_p)
    same = _same_tokens("hybrid", res_k, res_p, timed_k, timed_p)
    print(f"[hybrid] {_tokens_line(same)}; mamba_scan forward "
          f"launched {n_mamba * calls} times a wave ({n_mamba} layers x "
          f"{calls} calls; by route {scan_routes['mamba_scan']}); prefill "
          f"{stats['plain']['prefill_ms'] / stats['spec-kernel']['prefill_ms']:.1f}x"
          f" and decode "
          f"{stats['plain']['decode_ms_per_step'] / stats['spec-kernel']['decode_ms_per_step']:.1f}x"
          f" faster than the loops")
    wave = waves_k[0]
    t0 = time.perf_counter()
    _reset_scans()
    profile = _serve_profile(lambda: _serve(cfg, params, prompts,
                                            "spec-kernel"))
    _check_scans("hybrid-profile", {"mamba_scan": (n_mamba * calls, 0)},
                 scan_routes)
    _print_profile("hybrid", profile)
    print(f"[hybrid] same tokens for all {len(res_k)} requests and same "
          f"poison under both dispatches: {wave.moe_poison} of "
          f"{wave.moe_requests} dispatch requests poisoned "
          f"({wave.moe_poison / wave.moe_requests:.4%}); capacity {cap_p} "
          f"at prefill, {cap_d} at decode; launches "
          f"{ {k: v[0] for k, v in launches.items()} } (all by the bf16 "
          f"entry); profile {time.perf_counter() - t0:.1f} s")
    del params, timed_k, timed_s, timed_p
    _free()

    kgen = torch.Generator(device=dev).manual_seed(18)
    shapes = {}
    for tag, n_tok, cap in (("prefill", SERVE["requests"] * plen, cap_p),
                            ("decode", SERVE["requests"], cap_d)):
        idx, src, h = _moe_kernel_inputs(n_tok, cap, kgen, d=cfg.d_model,
                                         n_experts=cfg.n_experts,
                                         top_k=cfg.top_k)
        shapes[tag] = {
            "spec_scatter_add": _bf16_line("spec_scatter_add", idx,
                                           torch.zeros_like(h), src),
            "spec_gather": _bf16_line("spec_gather", idx, h, None)}
        del idx, src, h
        _free()
    for name in ("spec_gather", "spec_scatter_add"):
        for tag in ("prefill", "decode"):
            r = shapes[tag][name]
            print(f"[hybrid-kernels] {name} bf16 {tag} n={r['n']} "
                  f"d={r['d']} rows={r['rows']} live={r['n_live']}: bitwise "
                  f"equal to the plain version; device {r['ms'] * 1e3:.2f} "
                  f"us, plain {r['plain_ms'] * 1e3:.2f} us, library "
                  f"{r['library_ms'] * 1e3:.2f} us; byte bound "
                  f"{r['bound_ms'] * 1e3:.2f} us, "
                  f"{r['bound_ms'] / r['ms']:.1%} of it ({smi()})")
    out = {f"{name}_bf16": {
        "launches": launches[name][0], "prefill": shapes["prefill"][name],
        "decode": shapes["decode"][name], "stats": stats,
        "profile": profile, "moe_poison": wave.moe_poison,
        "moe_requests": wave.moe_requests}
        for name in ("spec_gather", "spec_scatter_add")}
    out["mamba_scan"] = {"launches": n_mamba * calls,
                         "routes": scan_routes["mamba_scan"], "tokens": same}
    return out


#: the cross families' runs: 8 rows of the serving prompts, 16 greedy
#: decode steps, stub memory from this seed
CROSS_SEED = 20


def phase_cross() -> None:
    """Llama-3.2-Vision-90B at full width with one layer group (n_layers
    100 -> 5) and Whisper-medium whole (24 + 24 layers), through
    ``Model.prefill`` / ``decode_step`` (the engine passes no memory) with
    seeded stub memory: 1024 patches, 1500 frames.  The enc-dec decode
    steps cross-attend to the memory the port's ``_encode`` gives once, as
    the reference's decode takes memory as passed."""
    import dataclasses
    from repro_torch.configs import base as cbase
    from repro_torch.models.model import build_model
    dev = torch.device("cuda")
    for arch, n_layers in (("llama_3_2_vision_90b", 5),
                           ("whisper_medium", None)):
        _free()
        _small_family_agrees(arch, "spec")
        full = cbase.get(arch)
        cfg = dataclasses.replace(full, n_layers=n_layers or full.n_layers)
        cut = (f"n_layers {full.n_layers} cut to {cfg.n_layers}, one "
               f"[(attn, mlp) x 4, (cross, mlp)] group, {cfg.n_patches} "
               f"patches" if n_layers else
               f"all {cfg.n_enc_layers} + {cfg.n_layers} layers, "
               f"{cfg.enc_len} frames")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(CROSS_SEED)
        model = build_model(cfg)
        params = model.init(gen, dev)
        torch.cuda.synchronize()
        _weights_line("cross", cfg, params, t0, cut)
        lens, prompts = _serve_prompts(cfg.vocab)
        plen = int(lens.max())
        toks = np.zeros((len(prompts), plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p
        toks = torch.from_numpy(toks).to(dev)
        pads = torch.from_numpy((plen - lens).astype(np.int32)).to(dev)
        mem = _stub_memory(cfg, len(prompts), gen, dev, cfg.torch_dtype)
        for run in ("warm-up", "timed"):
            timed = _TimedModel(model)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dec = model._encode(params, mem) if cfg.family == "encdec" \
                else mem
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - t1) * 1e3
            _, out = _greedy(timed, params, toks, SERVE["max_new"], mem, dec,
                             pads)
        if out.shape != (len(prompts), SERVE["max_new"] + 1) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            fail(f"cross {arch}: tokens {out}")
        enc = (f"; encoder alone {enc_ms:.2f} ms (its output is the decode "
               f"steps' memory)" if cfg.family == "encdec" else "")
        print(f"[cross] {cfg.name}: prefill {timed.prefill_s[0] * 1e3:.2f} "
              f"ms ({len(prompts)} x {plen} rows, memory "
              f"{tuple(mem.shape)}); decode "
              f"{float(np.mean(timed.decode_s)) * 1e3:.3f} ms a step "
              f"({len(timed.decode_s)} steps){enc}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi()})")
        _print_profile("cross", _serve_profile(lambda: _greedy(
            _TimedModel(model), params, toks, SERVE["max_new"], mem, dec,
            pads)))
        del params, mem, dec, model
    _free()


# ---------------------------------------------------------------------------
# training at full width
# ---------------------------------------------------------------------------

#: the full-width training traffic: SyntheticLM, global batch 8 of 256
#: tokens (2048 a step), 1 warm-up step, then TIMED steps and one profiled
TRAIN = dict(batch=8, seq_len=256, timed=5, seed=18)
#: bytes an optimizer step moves per parameter: AdamW reads the bf16
#: parameter and gradient and both float32 moments and writes the
#: moments and the parameter; Adafactor's state is O(rows + cols)
OPT_BYTES = {"adamw": 2 + 2 + 8 + 8 + 2, "adafactor": 2 + 2 + 2}
#: kernel-name fragments of the training profile's kinds
TRAIN_KINDS = (
    ("matmul", ("gemm", "xmma", "nvjet", "cutlass", "splitK")),
    ("elementwise", ("elementwise", "vectorized")),
)


def _train_kind(name: str) -> str:
    low = name.lower()
    for kind, parts in TRAIN_KINDS:
        if any(p.lower() in low for p in parts):
            return kind
    return "other"


def _no_kernel_launched(tag: str) -> None:
    """Fails unless no kernel of the port launched since ``_reset`` and
    ``_reset_dense``: the training path reaches none."""
    counts = _launches() + tuple(k.launches for k in _dense_kernels())
    if any(counts):
        fail(f"{tag}: kernels launched on the training path: {counts}")


def _reset_dense() -> None:
    for k in _dense_kernels():
        k.launches = 0


def _to(tree, device, clone=False):
    """``tree`` (a TrainState, dicts, lists) with every tensor on
    ``device`` (copied when ``clone``)."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: (t.to(device, copy=clone)
                               if torch.is_tensor(t) else t), tree)


def _train_batch(cfg, data, step, device, memory=None):
    b = {k: torch.from_numpy(v).to(device)
         for k, v in data.batch_at(step).items()}
    if memory is not None:
        b["frames" if cfg.family == "encdec" else "patches"] = \
            memory.to(device)
    return b


def _flat(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def phase_train_small() -> dict:
    """Every config's float32 smoke variant: 3 steps of the same
    ``make_train_step`` on the card and on the CPU from the same weights
    and batches (stub memory for vlm and encdec); losses within
    ``rtol = SMOKE_TOL`` and every parameter within ``atol = SMOKE_TOL``;
    the rwkv and jamba configs' scans launched as kernels on the card,
    forward and backward, once a layer a pass.  Then a gradient through
    ``dispatch="spec-kernel"`` and through each of the five Pallas sites'
    entries must raise on CUDA tensors, as ``jax.grad`` through the
    reference's Pallas kernels does.  Returns the scans' launches:
    backward, and forward by route (float32 takes the step routes)."""
    from repro_torch.configs import base as cbase
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import make_train_step, value_and_grad
    worst = 0.0
    scan_bwd, scan_fwd = {}, {}
    for arch in cbase.ASSIGNED:
        cfg = cbase.smoke(cbase.get(arch))
        init, step_fn, name = make_train_step(
            build_model(cfg, "spec"), peak_lr=1e-3, warmup=1, total=10)
        state0 = init(torch.Generator().manual_seed(7), "cpu")
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=2))
        mem = _stub_memory(cfg, 2, torch.Generator().manual_seed(8), "cpu",
                           torch.float32)
        runs = {}
        for dev in ("cpu", "cuda"):
            _reset_scans()
            state, losses = _to(state0, dev, clone=True), []
            for i in range(3):
                state, m = step_fn(state, _train_batch(cfg, data, i, dev,
                                                       mem))
                losses.append(float(m["loss"]))
            runs[dev] = (losses, [t.cpu() for t in _flat(state.params)],
                         int(state.step))
        # on the card each scan layer runs forward twice a step (the
        # group's checkpoint recomputes it) and backward once
        want = {n: (2 * 3 * k, 3 * k) for n, k in (
            ("rwkv6_scan", _n_sublayers(state0.params, "rwkv")),
            ("mamba_scan", _n_sublayers(state0.params, "mamba"))) if k}
        _check_scans(f"train-small {arch}", want,
                     {n: {"step": f} for n, (f, _) in want.items()},
                     {n: {"step": b} for n, (_, b) in want.items()})
        for n, (f, b) in want.items():
            scan_bwd[n] = scan_bwd.get(n, 0) + b
            scan_fwd[n] = scan_fwd.get(n, 0) + f
        (lc, pc, sc), (lg, pg, sg) = runs["cpu"], runs["cuda"]
        if sc != sg or sg != 3:
            fail(f"train-small {arch}: steps {sc} / {sg}")
        if not np.allclose(lg, lc, rtol=SMOKE_TOL, atol=0):
            fail(f"train-small {arch}: losses cuda {lg} cpu {lc}")
        err = max((a - b).abs().max().item() for a, b in zip(pc, pg))
        if err > SMOKE_TOL:
            fail(f"train-small {arch}: parameters differ cuda/cpu by {err}")
        worst = max(worst, err)
        print(f"[train-small] {arch} smoke config (float32, {name}): 3 "
              f"steps on the card, losses {', '.join(f'{x:.6f}' for x in lg)}"
              f" (CPU {', '.join(f'{x:.6f}' for x in lc)}); parameters "
              f"within {err:.3g} of the CPU's"
              + "".join(f"; {n} launched {f} forward, {b} backward"
                        for n, (f, b) in want.items()))
    # a gradient through a kernel raises, on the card as in the reference
    cfg = cbase.smoke(cbase.get("kimi_k2_1t_a32b"))
    model = build_model(cfg, "spec-kernel")
    params = model.init(torch.Generator(device="cuda").manual_seed(9),
                        "cuda")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=2))
    _reset()
    try:
        value_and_grad(model, params, _train_batch(cfg, data, 0, "cuda"))
    except NotImplementedError:
        pass
    else:
        fail("train-small: dispatch=spec-kernel took a gradient on the card")
    dev = torch.device("cuda")

    def f(*shape):
        return torch.randn(shape, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    calls = {
        "spec_gather": lambda g: ops.spec_gather(
            f(16, 8).requires_grad_(g), torch.tensor([0, 3, -1], **i32)),
        "spec_scatter_add": lambda g: ops.spec_scatter_add(
            f(16, 8), torch.tensor([0, 3, -1], **i32),
            f(3, 8).requires_grad_(g)),
        "ragged_matmul": lambda g: ops.ragged_matmul(
            f(16, 64).requires_grad_(g), f(2, 64, 64), 8),
        "flash_attention": lambda g: ops.flash_attention(
            f(1, 2, 16, 64).requires_grad_(g), f(1, 2, 16, 64),
            f(1, 2, 16, 64)),
        "paged_attention": lambda g: ops.paged_attention(
            f(2, 2, 64).requires_grad_(g), f(4, 8, 2, 64), f(4, 8, 2, 64),
            torch.tensor([[0, 1], [2, 3]], **i32),
            torch.tensor([10, 5], **i32)),
    }
    for name, call in calls.items():
        try:
            call(True)
        except NotImplementedError:
            pass
        else:
            fail(f"train-small: {name} took a gradient on the card")
    _reset()
    _reset_dense()
    torch.cuda.synchronize()
    print(f"[train-small] all {len(cbase.ASSIGNED)} configs agree card "
          f"against CPU (parameters within {worst:.3g}, atol {SMOKE_TOL}); "
          f"on CUDA tensors a gradient through dispatch=spec-kernel and "
          f"through each of the {len(calls)} kernel entries raises "
          f"NotImplementedError; the scans' backward kernels launched "
          f"{scan_bwd}, their forward ones {scan_fwd} (float32: all by the "
          f"step routes, forward and backward)")
    return {"bwd": scan_bwd, "fwd_step": scan_fwd}


def _multiply_params(cfg, params) -> float:
    """Parameters that multiply per token, the embedding excluded: every
    matrix, the MoE experts at top_k of n_experts."""
    n = 0.0
    for g in params["groups"] + params.get("enc_groups", []):
        for sub in g.values():
            for k, t in sub.items():
                if t.dim() >= 2:
                    share = cfg.top_k / cfg.n_experts if (
                        t.dim() == 3 and k.startswith("w_")) else 1.0
                    n += t.numel() * share
    return n + params["lm_head"].numel()


def _train_profile(run) -> dict:
    """``run()`` (one train step) under ``torch.profiler``: the step's
    host window (ending in a sync), the device's busy time in it, the
    idle share, and device time by part and kind of kernel.  Forward and
    optimizer are the kernels inside the device-side spans of the step's
    ``train.forward`` and ``train.optimizer`` ranges (both launched from
    this thread); backward, with its recompute, is every kernel between
    them (autograd launches it from its own thread); the rest (the step
    counter's increment) falls outside all three."""
    from torch.autograd import DeviceType
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        with torch.profiler.record_function("train.step"):
            run()
            torch.cuda.synchronize()
    window, spans, kernels = None, {}, []
    for ev in prof.events():
        span = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == DeviceType.CPU:
            if ev.name == "train.step":
                window = span
        elif ev.name in ("train.forward", "train.optimizer"):
            b, e = spans.get(ev.name, (span[0], span[1]))
            spans[ev.name] = (min(b, span[0]), max(e, span[1]))
        elif not ev.name.startswith("train."):
            kernels.append((ev.time_range.start, ev.time_range.end,
                            ev.name))
    if window is None or len(spans) != 2:
        fail(f"train profile: no step window or device spans ({spans})")
    kernels.sort()
    fwd, opt = spans["train.forward"], spans["train.optimizer"]
    parts = {p: collections.Counter() for p in
             ("forward", "backward", "optimizer", "rest")}
    names = collections.Counter()
    busy, end = 0.0, window[0]
    for kb, ke, name in kernels:
        kb, ke = max(kb, window[0]), min(ke, window[1])
        if ke <= kb:
            continue
        mid = (kb + ke) / 2
        part = ("forward" if fwd[0] <= mid <= fwd[1] else
                "optimizer" if opt[0] <= mid <= opt[1] else
                "backward" if fwd[1] < mid < opt[0] else "rest")
        parts[part][_train_kind(name)] += ke - kb
        names[name] += ke - kb
        busy += max(0.0, ke - max(kb, end))
        end = max(end, ke)
    wms = (window[1] - window[0]) / 1e3
    return {"window_ms": wms, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / 1e3 / wms,
            "parts": {p: {k: v / 1e3 for k, v in c.most_common()}
                      for p, c in parts.items()},
            "by_name": {k: v / 1e3 for k, v in names.most_common()}}


def _train_full(tag, cfg, cut, opt, dispatch="spec", opt_cfg=None,
                batch=None, seq_len=None) -> dict:
    """The training phase at full width: weights and optimizer state
    drawn on the card (the optimizer must be ``opt``), the MoE poison
    share of the first batch, 1 warm-up step, ``TRAIN["timed"]`` steps
    timed by the host clock ending in a sync, one profiled step, at
    ``batch`` sequences of ``seq_len`` tokens (``TRAIN``'s by default);
    no kernel of the port but the scans may launch (the caller checks
    the scans'; the returned ``scans`` holds their launches over the
    warm-up and timed steps)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import make_train_step
    _free()
    dev = torch.device("cuda")
    model = build_model(cfg, dispatch)
    init, step_fn, opt_name = make_train_step(model, opt_cfg=opt_cfg)
    if opt_name != opt:
        fail(f"{tag}: make_optimizer picked {opt_name}, not {opt}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init(torch.Generator(device=dev).manual_seed(TRAIN["seed"]), dev)
    torch.cuda.synchronize()
    _weights_line(tag, cfg, state.params, t0, cut)
    n_seq = batch or TRAIN["batch"]
    seq_len = seq_len or TRAIN["seq_len"]
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                  global_batch=n_seq))
    tokens = n_seq * seq_len
    n_params = sum(t.numel() for t in _flat(state.params))
    n_mult = _multiply_params(cfg, state.params)
    flop_ms = 8 * n_mult * tokens / BF16_FLOP_PER_S * 1e3
    opt_ms = OPT_BYTES[opt_name] * n_params / HBM_BYTES_PER_S * 1e3
    if cfg.n_experts:
        _train_poison(tag, model, state.params, _train_batch(cfg, data, 0,
                                                             dev))
    _reset()
    _reset_dense()
    _reset_scans()
    losses, times = [], []
    for i in range(1 + TRAIN["timed"]):
        batch = _train_batch(cfg, data, i, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(time.perf_counter() - t1)
    _no_kernel_launched(tag)
    scans = (_scan_launches(), _scan_routes(), _scan_bwd_routes())
    peak = torch.cuda.max_memory_allocated()
    if not np.all(np.isfinite(losses)) or not (
            0.5 * np.log(cfg.vocab) < losses[0] < 2.5 * np.log(cfg.vocab)):
        fail(f"{tag}: losses {losses} (log vocab {np.log(cfg.vocab):.3f})")
    if int(state.step) != len(losses):
        fail(f"{tag}: step {int(state.step)} after {len(losses)} steps")
    step_ms = float(np.median(times[1:])) * 1e3
    print(f"[{tag}] {opt_name}, dispatch={dispatch}, {n_seq} x "
          f"{seq_len} tokens a step: step ms "
          + ", ".join(f"{t * 1e3:.1f}" for t in times[1:])
          + f" (median {step_ms:.1f}; warm-up {times[0] * 1e3:.1f}); "
          f"{tokens / step_ms * 1e3:.0f} tokens/s; losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f" (log vocab {np.log(cfg.vocab):.4f}); peak device memory "
          f"{peak / 1e9:.2f} GB ({smi()})")
    print(f"[{tag}] bounds: FLOP bound {flop_ms:.2f} ms (8 x "
          f"{n_mult / 1e9:.3f}e9 multiplying parameters x {tokens} tokens: forward, backward "
          f"and the remat's second forward, over 989 TFLOP/s bf16; "
          f"{flop_ms / step_ms:.1%} of the median step); optimizer byte "
          f"bound {opt_ms:.2f} ms ({OPT_BYTES[opt_name]} bytes x "
          f"{n_params / 1e9:.3f}e9 parameters over 3.35 TB/s); no kernel "
          f"of the port launched"
          + (" but the scans" if any(map(any, scans[0].values())) else ""))
    batch = _train_batch(cfg, data, len(losses), dev)
    prof = _train_profile(lambda: step_fn(state, batch))
    parts = prof["parts"]
    print(f"[{tag}-profile] one step (profiled): window "
          f"{prof['window_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
          f"ms, idle {prof['idle_share']:.1%}; " + "; ".join(
              f"{p} {sum(k.values()):.2f} ms (" + ", ".join(
                  f"{n} {v:.2f}" for n, v in k.items()) + ")"
              for p, k in parts.items()) + f" ({smi()})")
    return {"step_ms": step_ms, "tokens_s": tokens / step_ms * 1e3,
            "losses": losses, "peak_bytes": peak, "flop_ms": flop_ms,
            "opt_ms": opt_ms, "profile": prof, "scans": scans,
            "steps": len(losses)}


def _train_poison(tag, model, params, batch) -> None:
    """Poisoned MoE dispatch requests of one forward over ``batch``
    (exact counts, from ``_run_groups(collect_stats=True)``)."""
    from repro_torch.models.moe import round_capacity
    cfg = model.cfg
    tok = batch["tokens"].long()
    with torch.no_grad():
        _, _, _, poison = model._run_groups(params, params["embed"][tok],
                                            collect_stats=True)
    n_moe = sum(k == "moe" for k in _pattern(cfg)) * len(params["groups"])
    n_req = tok.numel() * cfg.top_k * n_moe
    cap = round_capacity(tok.numel(), cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
    print(f"[{tag}] poison share of the first training batch: "
          f"{int(poison)} of {n_req} dispatch requests "
          f"({int(poison) / n_req:.2%}), capacity {cap} rows an expert")


def _pattern(cfg):
    from repro_torch.models.model import group_pattern
    return group_pattern(cfg)


def phase_train_dense() -> None:
    """Phi-4-mini-3.8B whole (32 layers, nothing cut), bf16, AdamW."""
    from repro_torch.configs import base as cbase
    cfg = cbase.get("phi4_mini_3_8b")
    _train_full("train-dense", cfg, f"all {cfg.n_layers} layers, nothing "
                f"cut", "adamw")
    _free()


def phase_train_moe() -> None:
    """Grok-1-314B at full width, one [attn, moe] group (n_layers 64 ->
    1), ``dispatch="spec"``, Adafactor as ``make_optimizer`` picks for the
    whole model."""
    import dataclasses
    from repro_torch.configs import base as cbase
    full = cbase.get("grok_1_314b")
    cfg = dataclasses.replace(full, n_layers=1)
    small_opt = ("adafactor" if cbase.param_count(cfg)[0] > 100e9
                 else "adamw")
    print(f"[train-moe] optimizer from make_optimizer(get('grok_1_314b')): "
          f"{cbase.param_count(full)[0] / 1e9:.1f}e9 parameters pick "
          f"adafactor; the cut config's {cbase.param_count(cfg)[0] / 1e9:.2f}"
          f"e9 would pick {small_opt}, whose "
          f"{8 * cbase.param_count(cfg)[0] / 1e9:.1f} GB of float32 moments "
          f"do not fit beside the bf16 weights and gradients")
    _train_full("train-moe", cfg, f"n_layers {full.n_layers} cut to 1, "
                f"one [attn, moe] group, {cfg.n_experts} experts "
                f"top-{cfg.top_k}", "adafactor", opt_cfg=full)
    _free()


#: [train-ssm]: RWKV-6-7B's layers kept, and the tokens of a step (2
#: sequences of 1024: RWKV-6 trains at long contexts)
TRAIN_SSM = dict(n_layers=8, batch=2, seq_len=1024)
#: [train-ssm]'s second run: Jamba's smoke config in bf16, the sequences
#: and tokens of a step
TRAIN_SSM_JAMBA = dict(batch=2, seq_len=64)
#: kernel-name fragments of the scans' chunked backward kernels
SCAN_BWD_KERNELS = ("rwkv6_bound_kernel", "rwkv6_grad_kernel",
                    "mamba_bound_kernel", "mamba_grad_kernel", "colsum_kernel")


@contextlib.contextmanager
def _no_plain_scans():
    """The plain loops and plain chunked backward raise if called: a
    CUDA path must never reach them."""
    from repro_torch.kernels import ref
    names = ("rwkv6_scan", "mamba_scan", "rwkv6_scan_bwd_chunked",
             "mamba_scan_bwd_chunked")
    saved = {n: getattr(ref, n) for n in names}

    def refuse(*args, **kw):
        fail("a CUDA tensor reached a plain scan")

    for n in names:
        setattr(ref, n, refuse)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ref, n, f)


def _scan_bwd_ms(by_name: dict, fragments) -> float:
    return sum(v for k, v in by_name.items()
               if any(f in k for f in fragments))


def phase_train_ssm() -> dict:
    """RWKV-6-7B at its published width (d_model 4096, 64 heads of 64,
    d_ff 14336, vocab 65536, bf16), n_layers 32 cut to 8, AdamW as
    ``make_optimizer(get("rwkv6_7b"))`` picks for the whole model,
    ``dispatch="spec"``, 2 sequences of 1024 tokens a step through
    :func:`_train_full`: the scans' backward launched by the chunked
    route once a layer a step, never by the step pair, and no plain loop
    reached.  The profiled step's scan backward device time is the
    kernels of both backward routes.  Then the Jamba smoke config in
    bf16, 3 steps on the card: the Mamba backward by its chunk route
    once a Mamba layer a step.  Returns the backward launches by route
    of both runs."""
    import dataclasses
    from repro_torch.configs import base as cbase
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import make_train_step
    full = cbase.get("rwkv6_7b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_SSM["n_layers"])
    cut = (f"n_layers {full.n_layers} cut to {cfg.n_layers} "
           f"({cbase.param_count(full)[0] / 1e9:.2f}e9 parameters whole "
           f"need ~{12 * cbase.param_count(full)[0] / 1e9:.0f} GB of bf16 "
           f"weights and gradients and float32 AdamW moments; "
           f"{cbase.param_count(cfg)[0] / 1e9:.2f}e9 kept)")
    print(f"[train-ssm] optimizer from make_optimizer(get('rwkv6_7b')): "
          f"{cbase.param_count(full)[0] / 1e9:.2f}e9 parameters pick adamw; "
          f"{cut}")
    with _no_plain_scans():
        res = _train_full("train-ssm", cfg, cut, "adamw",
                          opt_cfg=full, batch=TRAIN_SSM["batch"],
                          seq_len=TRAIN_SSM["seq_len"])
    (launches, fwd, bwd), steps = res["scans"], res["steps"]
    n = cfg.n_layers
    want = {"rwkv6_scan": (2 * n * steps, n * steps)}
    if launches != {**dict.fromkeys(launches, (0, 0)), **want} or \
            bwd["rwkv6_scan"] != {"chunked": n * steps, "step": 0} or \
            fwd["rwkv6_scan"]["chunked"] != 2 * n * steps:
        fail(f"train-ssm: scan launches {launches}, forward by route {fwd}, "
             f"backward by route {bwd}; want {want}, every forward chunked "
             f"and every backward by the chunked route")
    by_name = res["profile"]["by_name"]
    bwd_ms = _scan_bwd_ms(by_name, SCAN_BWD_KERNELS)
    fwd_ms = _scan_bwd_ms(by_name, ("rwkv6_chunk_kernel",))
    print(f"[train-ssm] the scans in the profiled step: backward "
          f"{bwd_ms:.3f} ms of device time by the chunked route "
          f"({n} launches), "
          f"forward {fwd_ms:.3f} ms (chunked route, {2 * n} launches with "
          f"the checkpoint's recompute); over the {steps} steps the "
          f"backward launched {bwd['rwkv6_scan']} by route and the forward "
          f"{fwd['rwkv6_scan']}; no plain loop reached ({smi()})")
    out = {"rwkv6_scan": dict(bwd["rwkv6_scan"]), "train": {
        k: res[k] for k in ("step_ms", "tokens_s", "losses", "peak_bytes",
                            "flop_ms")} | {"scan_bwd_ms": bwd_ms,
                                           "scan_fwd_ms": fwd_ms}}
    _free()
    # the Mamba chunk backward on a training path: Jamba's smoke config in
    # bf16 on the card
    scfg = dataclasses.replace(cbase.smoke(cbase.get("jamba_1_5_large_398b")),
                               dtype="bfloat16")
    model = build_model(scfg, "spec")
    init, step_fn, name = make_train_step(model, peak_lr=1e-3, warmup=1,
                                          total=10)
    state = init(torch.Generator(device="cuda").manual_seed(11), "cuda")
    data = SyntheticLM(DataConfig(vocab=scfg.vocab,
                                  seq_len=TRAIN_SSM_JAMBA["seq_len"],
                                  global_batch=TRAIN_SSM_JAMBA["batch"]))
    n_mamba = _n_sublayers(state.params, "mamba")
    _reset_scans()
    losses = []
    with _no_plain_scans():
        for i in range(3):
            state, m = step_fn(state, _train_batch(scfg, data, i, "cuda"))
            losses.append(float(m["loss"]))
    _check_scans("train-ssm jamba smoke", {
        "mamba_scan": (2 * 3 * n_mamba, 3 * n_mamba)},
        {"mamba_scan": {"chunk": 2 * 3 * n_mamba}},
        {"mamba_scan": {"chunk": 3 * n_mamba}})
    lv = np.log(scfg.vocab)
    if not np.all(np.isfinite(losses)) or not 0.5 * lv < losses[0] < 2.5 * lv:
        fail(f"train-ssm jamba smoke: losses {losses}")
    print(f"[train-ssm] {scfg.name} smoke config in bf16 ({name}), 3 steps "
          f"on the card: losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"(log vocab {lv:.4f}); the Mamba scan launched "
          f"{2 * 3 * n_mamba} forward by the chunk route and "
          f"{3 * n_mamba} backward by the chunk route")
    out["mamba_scan"] = dict(_scan_bwd_routes()["mamba_scan"])
    _reset_scans()
    del state, model
    _free()
    return out


def phase_train_ckpt() -> None:
    """On the card at a bf16 smoke config: train, save_async and wait, a
    fresh ``train()`` that restores LATEST and continues; the restored
    tensors on the card, in their dtypes, bitwise the saved ones."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs import base as cbase
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import TrainerConfig, train
    cfg = dataclasses.replace(cbase.smoke(cbase.get("phi4_mini_3_8b")),
                              dtype="bfloat16")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(ROOT,
                                                                "build"))
    try:
        kw = dict(ckpt_dir=d, ckpt_every=2, global_batch=2, seq_len=16)
        logs = []
        out1 = train(cfg, TrainerConfig(steps=4, **kw), log=logs.append,
                     device=None)
        mgr = CheckpointManager(d)
        mgr.save_async(4, out1["state"])
        mgr.wait()
        back = mgr.restore(shard_fn=lambda t: _to(t, "cuda"))
        saved = _flat(out1["state"])
        restored = _flat(back)
        if len(saved) != len(restored):
            fail(f"train-ckpt: {len(restored)} tensors of {len(saved)}")
        for a, b in zip(saved, restored):
            if b.device.type != "cuda" or b.dtype != a.dtype or not \
                    torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8)):
                fail(f"train-ckpt: restored {b.dtype} on {b.device} vs "
                     f"saved {a.dtype}")
        n_bf16 = sum(t.dtype == torch.bfloat16 for t in restored)
        out2 = train(cfg, TrainerConfig(steps=7, **kw), log=logs.append,
                     device=None)
        if f"[trainer] restored step 4 from {d}" not in logs or int(
                out2["state"].step) != 7 or len(out2["losses"]) != 3 or \
                not np.all(np.isfinite(out2["losses"])):
            fail(f"train-ckpt: restart {logs}, step "
                 f"{int(out2['state'].step)}")
        print(f"[train-ckpt] {cfg.name} smoke config in bf16 on the card: "
              f"4 steps, save_async + wait, {len(restored)} tensors restored "
              f"bitwise on cuda in their dtypes ({n_bf16} bf16); a fresh "
              f"train() restored step 4 from LATEST and ran to step 7 "
              f"(losses {', '.join(f'{x:.4f}' for x in out2['losses'])}); "
              f"steps on disk {CheckpointManager(d).all_steps()}")
    finally:
        shutil.rmtree(d, ignore_errors=True)


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
    scans = phase_scan()
    line["kernels"] += scans
    line["kernels"] += phase_serve_full()
    grok = phase_mesh_shards_grok()
    for rec in line["kernels"]:
        if "mesh" in rec:  # the two bf16 entries
            rec["mesh"]["shards"]["tp2_grok"] = grok[
                rec["name"].removesuffix("_bf16")]
    line["mesh_attn"] = phase_mesh_attn()
    dry = phase_dryrun()
    line["dryrun"] = dry
    ssm = phase_ssm()
    hybrid = phase_hybrid()
    for rec in line["kernels"]:
        if rec["name"] in hybrid:
            rec["jamba"] = hybrid[rec["name"]]
    phase_cross()
    train = phase_train_small()
    phase_train_dense()
    phase_train_moe()
    ssm_train = phase_train_ssm()
    # the scans' launches by route on their main paths: the bf16 forward
    # routes in one served wave ([ssm], [hybrid]); the float32 step routes,
    # forward and backward, in [train-small]; the chunked backward routes
    # in [train-ssm] (RWKV-6-7B at full width; Jamba's smoke config in
    # bf16)
    small = "[train-small] smoke configs (float32), 3 steps"
    served = {"rwkv6_scan": (ssm, "[ssm] RWKV-6-7B wave"),
              "mamba_scan": (hybrid["mamba_scan"], "[hybrid] Jamba wave")}
    trained = {"rwkv6_scan": f"[train-ssm] RWKV-6-7B, {TRAIN_SSM['n_layers']} "
                             f"layers at full width, bf16",
               "mamba_scan": "[train-ssm] Jamba smoke config, bf16, 3 steps"}
    for rec in scans:
        name, route = rec["scan"], rec["scan_route"]
        wave, where = served[name]
        if route == "bwd_step":
            rec["launches"], rec["main_path"] = train["bwd"][name], small
        elif route.startswith("bwd_"):
            rec["launches"] = ssm_train[name][route.removeprefix("bwd_")]
            rec["main_path"] = trained[name]
            if name == "rwkv6_scan":
                rec["train_ssm"] = ssm_train["train"]
        elif wave["routes"].get(route):
            rec["launches"], rec["main_path"] = wave["routes"][route], where
            rec["tokens_vs_plain"] = wave["tokens"]
        else:
            rec["launches"] = train["fwd_step"][name]
            rec["main_path"] = small
        if not rec["launches"]:
            fail(f"{rec['name']}: no launch on its main path")
    phase_train_ckpt()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
