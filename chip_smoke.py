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
and backward) against their plain loops: float32 by the chunked routes
(RWKV-6 chunked, Mamba chunk) at a small odd T, then forward and
backward against the float32 loop at full width (T 2 to 2048) and at
``[train-small]``'s shapes (heads of 16, 64 Mamba channels), and at 8 x
512 and B = 2, T = 2048 beside the step routes; the new bf16 routes against
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
with the workspace it allocates.  The step pairs (the nineteenth slice:
unit boundaries kept, each unit walked back alone, fixed-order sums) are
also swept through autograd on what the chunked routes refuse (T = 1,
unaligned tensors, Mamba's widths off the vector) and run twice on the
same inputs, bitwise.  The step forwards (the twentieth slice: RWKV-6's
kernel of T >= 2, a tile of the state a thread and the read-out's sums in
a fixed tree of shuffles; Mamba's, runs of 16 steps staged while the last
is walked) are swept through the entry at T from 1 to 2048 off the
16-byte boundary and at Mamba's widths off the vector: the state bitwise
the loop's, y bitwise the plain version that sums in the kernel's order,
two runs bitwise; ``[build]`` counts their SASS instructions a state
element a step, and ``[scan]`` times each beside that floor.  ``[attn]``
(the fourteenth slice)
holds the chunked-attention kernels (``csrc/chunked_attention.cu``, the
reference's ``lax.scan`` over key chunks) to their plain loop: an edge
sweep of float32 and bf16, head widths 16, 64 and 128, causal and not,
``q_offset`` 0 and 37, Tq from 1 to 1500 against Tk from 1 to 1500
(output and the gradients of q, k and v; bf16 no further from the loop
in float32 than the bf16 loop plus one bf16 ulp), then each main path's
shape in bf16 (the Whisper encoder, Whisper and Llama-3.2-Vision cross
attention in prefill and decode, Phi-4-mini and Grok-1 training, forward
and backward), timed beside the loop, ``scaled_dot_product_attention``
and the bound.  The bf16 kernels take routes
(``chunked_attention.attn_plan``): ``tile`` and ``split`` in
``csrc/chunked_attention_sm90.cu`` and the tile backward in
``csrc/chunked_attention_bwd_sm90.cu`` (TMA + ``wgmma``; split keys for
one query; head widths 112 and 160 padded to whole 64-column chunks in
shared memory), ``head`` (``csrc/chunked_attention_head.cu``, the
eighteenth slice: d 16 with at most 64 queries and keys, float32 too,
one block a head and one launch a way) and the first kernels' ``mma``
(``simt`` in float32) past it; ``[attn]`` sweeps every width and the head
route's own edges, times each path's planned route beside the ``mma``
route on the same inputs (Kimi-K2 and StableLM-12B training among the
paths; ``head`` beside ``simt`` and ``mma`` at the float32 and the bf16
smoke shapes, with a launch floor), sweeps the split / tile threshold,
and the kernels line has a record a route and way, its launches summed
over the main paths that take it (``mma`` and ``simt``, which no main
path takes now, under ``attn_baselines``).
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
seeded stub memory, 16 greedy steps, timed and profiled, the
chunked-attention kernel launched once a cross sublayer and encoder
layer a call (counted; the plain loop fails on a CUDA tensor), and
serves each wave again with attention as its plain loop, which must
commit the same tokens (or a bf16 argmax tie, reported with its logit
gap).
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
and optimizer by kind of kernel; every training phase counts the
chunked-attention launches (forward twice a layer a step with the
checkpoint's recompute, backward once) and fails if the plain loop ran
on a CUDA tensor; ``[train-kimi]`` trains one Kimi-K2 group at full
width with 128 of its 384 experts (Adafactor, as the whole model takes
it, ``TRAIN``'s 8 x 256 tokens) and fails unless every chunked-attention
launch took the tile route at head width 112; ``[train-ssm]`` trains
RWKV-6-7B at its published width with 8 of its 32 layers (AdamW, as the
whole model takes it), 2 sequences of 1024 tokens a step, the same lines
plus the
scan backward's device time in the profiled step, and fails unless the
backward took the chunked route once a layer a step and no plain loop
was reached; then Jamba's smoke config in bf16 trains 3 steps on the
card through the Mamba chunk backward; ``[train-jamba]`` trains one
Jamba group (7 Mamba and 1 attention layers) at full width with 4 of
its 16 experts (Adafactor, 2 x 1024 tokens a step) and fails unless
every Mamba forward and backward took the chunk route, the step pair
never launched and every attention launch took the tile route at head
width 128, printing the scans' device time in the profiled step;
``[train-stablelm]`` trains
StableLM-12B at its published width with 8 of its 40 layers (AdamW,
``TRAIN``'s 8 x 256 tokens) and fails unless every chunked-attention
launch, forward and backward, took the tile route at head width 160,
printing the attention's device time in the profiled step's forward and
backward ranges; ``[train-ckpt]`` saves a bf16 smoke
run on the card asynchronously, restores it bitwise and continues it
through a fresh ``train()``.
Phases print as they finish, each with a ``[time]`` line of its
seconds; the last lines are one
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


def queued_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one eager ``fn()`` in ms, for calls a CUDA graph
    cannot capture: CUDA events around ``reps`` calls enqueued while the
    stream waits behind a device-side sleep, so that the host's issue time
    does not sit between their kernels.  The sleep's length, from the
    host time of one call and the H100's 1.98 GHz boost clock, is only a
    guess at a lower bound: what validates a reading is that the start
    event is still pending once all calls are enqueued; else the sleep
    grows and the calls run again.  Used for SDPA's backward, whose
    cuDNN kernels the profiler does not see inside this script (why is
    not known)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for grow in (4, 16, 64):
        # cycles at the H100's 1.98 GHz: a slower clock sleeps longer
        torch.cuda._sleep(int(max(0.02, grow * reps * host) * 1.98e9))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(stop) / reps
    fail(f"queued_ms: {reps} calls not enqueued within the sleep")


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
                             r"colsum|attn)\w*?_kernel\w*?(?:Li\d+E)*)",
                             block.split("\n", 1)[0])
            local[name.group(1) if name else block[:40]] = n
    out["LDL/STL"] = sum(local.values())
    out["kernels with local memory"] = local or "none"
    return out


#: the step forwards' SASS counts
#: (``repro_torch.launch.step_fwd_variants.per_element_step``) by library,
#: from ``[build]``
STEP_FWD_COUNTS: dict = {}


def _step_fwd_floor(kind, dtype, shape, clock) -> dict:
    """The step forward's counted-instruction floor at ``shape`` (B, T,
    width): its SASS instructions a state element a step (``[build]``)
    over the card's thread-instruction rate, 128 lanes an SM a clock; {}
    without the counts."""
    from repro_torch.launch import step_fwd_variants as sv
    lib = "rwkv6_scan" if kind == "rwkv" else "mamba_scan"
    c = STEP_FWD_COUNTS.get(lib, {}).get(str(dtype).removeprefix("torch."))
    if not c:
        return {}
    b, t, width = shape
    elems = b * t * width * (SCAN_HD if kind == "rwkv" else SCAN_N)
    return {"kernel": sv.KERNELS[lib][0],
            "sass_per_element_step": c["per_element_step"],
            "instruction_floor_ms": c["per_element_step"] * elems
            / (N_SM * 128 * clock) * 1e3}


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
            elif "warning" in line.lower() or "Performance Loss" in line:
                print(f"[build] {name}: {line}")
    for name in sorted(build.SIGNATURES):
        counts = _sass_counts(build.library_path(name))
        if counts:
            print(f"[build] {name} SASS: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()))
    from repro_torch.launch import step_fwd_variants as sv
    for lib, (fragment, *_) in sv.KERNELS.items():
        STEP_FWD_COUNTS[lib] = sv.per_element_step(build.library_path(lib),
                                                   lib)
        for dtype, c in STEP_FWD_COUNTS[lib].items():
            print(f"[build] {fragment} {dtype} SASS: "
                  f"{c['per_element_step']:.3f} instructions a state element "
                  f"a step ({c['instructions']} in the hot loop's "
                  f"{c['steps_an_iteration']:g} steps; {c['top_ops']})")
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
#: the float32 routes' sweep (forward and backward in one pass): fewer T
#: than the bf16 sweep's, the chunk's and the unit's edges and the longest;
#: the float32 loop's own gradients are held to float64 up to the last but
#: one (the float64 backward at T = 2048 would double the sweep's time)
SCAN_SWEEP_T_F32 = (2, 17, 65, 2048)
#: batch and tokens of ``[train-small]``'s steps (every config's float32
#: smoke variant)
TRAIN_SMALL = dict(batch=2, seq_len=16)
#: the speed-up of the float32 forward chunked routes over the step
#: kernels below which [scan] prints a note (RWKV-6, Mamba): a few percent
#: under the ratios measured on one H100 once the step kernels were
#: redesigned for T >= 2 (PERF.md, rows 6f and 7c)
SCAN_FWD_GAIN = {"rwkv": 1.7, "mamba": 1.55}
#: the share of a workspace of every step's float32 state above which
#: [scan] prints a note on a backward, by route: the chunked routes, the
#: step pairs
SCAN_BWD_WS_SHARE = {"chunked": 1 / 16, "chunk": 1 / 16, "step": 1 / 8}
#: the step forwards' edge sweep: T, and (width, unaligned) of each kind
#: at each T (RWKV-6 at T >= 2 and Mamba at T = 1 take the step route only
#: off the 16-byte boundary; Mamba's widths 8190 and 30 are off the
#: vector), B = 2, in both dtypes and the three decay regimes
STEP_FWD_T = (1, 2, 15, 16, 17, 33, 512, 2048)
STEP_FWD_EDGES = {
    "rwkv": lambda t: [(4096, True)] + ([(4096, False)] if t == 1 else []),
    "mamba": lambda t: [(8192, True), (8190, t == 1), (30, t == 1)]}
#: the step pairs' edge sweep: (B, T, width, unaligned) of each kind, at
#: full width (Mamba's also off the 16-byte vector in both dtypes)
STEP_BWD_EDGES = {"rwkv": [(2, 1, 4096, False), (2, 17, 4096, True),
                           (2, 65, 4096, True)],
                  "mamba": [(2, 1, 8192, False), (2, 17, 8190, False),
                            (2, 65, 8192, True), (2, 65, 8190, False)]}


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


def _scan_args(kind, b, t, width, dtype, gen, regime="model", hd=SCAN_HD):
    """Seeded inputs of one scan, made on the card: RWKV-6 at d_model
    ``width`` in heads of ``hd``, Mamba at ``width`` channels (N = 16).
    Decays and deltas in the ranges the models give them (``regime="model"``:
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
        h = width // hd
        shape = (b, t, h, hd)
        if regime == "model":
            w = torch.sigmoid(torch.randn(shape, generator=gen, device=dev)
                              + 2)
        elif regime == "near0":
            w = rand(*shape) * 1e-3
            w[..., ::5] = 0.0
        else:
            w = 1 - rand(*shape) * 1e-3
        return [f(*shape, scale=0.5), f(*shape, scale=0.5), f(*shape),
                w.to(dtype), f(h, hd, scale=0.5),
                torch.randn((b, h, hd, hd), generator=gen, device=dev) * 0.3]
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


def _scan_bytes(kind, bwd, b, t, width, elem) -> int:
    """Bytes of one scan call at these shapes, activations of ``elem``
    bytes (2 bf16, 4 float32; the state and A are float32): each input
    read once and each output written once (the backward's workspace is
    the kernel's choice, not the function's work)."""
    if kind == "rwkv":
        act, par = b * t * width * elem, width * elem
        state = b * (width // SCAN_HD) * SCAN_HD * SCAN_HD * 4
        fwd = 5 * act + par + 2 * state
        return fwd + (4 * act + par + state if bwd else 0)
    act, small = b * t * width * elem, b * t * (1 + 2 * SCAN_N) * elem
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


def _scan_bound(kind, route, bwd, b, t, width, clock, elem) -> dict:
    """The least time of one scan call by this route at these shapes: the
    larger of the bytes over 3.35 TB/s and the route's operations over
    their rate.  Step routes (and the backward): :data:`SCAN_OPS` float32
    operations a state element a step at 67 TFLOP/s.  RWKV-6 chunked: the
    chunked form's products at the TF32 rate, 4 hd^2 + 4 C hd a (token,
    head) forward (the state update and read-out, the scores and their
    product with v), 10 hd^2 + 6 C hd backward (the boundary passes' two
    updates, S dy, G v and (k q) G; v.dy, the scores and their product
    with dy).  Mamba chunk: one exp a state element a step on the
    special-function units, forward and backward; Mamba's step forward:
    the larger of that and the step-serial count.  Also the step-serial
    count's bound (``old``) beside every route's, for comparison.
    ``elem``: the activations' bytes."""
    nbytes = _scan_bytes(kind, bwd, b, t, width, elem)
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
    elif kind == "mamba" and route == "step" and not bwd:
        # the step route's forward: an exp a state element a step on the
        # special-function units, or the step-serial count, the larger
        t_sfu = elems / (SFU_EXP_PER_CLOCK * N_SM * clock) * 1e3
        t_f32 = old_ops / F32_FLOP_PER_S * 1e3
        ops, kind_ops, t_ops = ((elems, "sfu exp", t_sfu) if t_sfu >= t_f32
                                else (old_ops, "float32", t_f32))
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
    return _scan_outs_grads(fn, args, seed)[1][0]


def _scan_cots(s, y, seed):
    """Seeded cotangents of a scan's last state and of y, in their dtypes
    (the same values in float32 and float64)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w_s = torch.randn(s.shape, generator=g, device="cuda").to(s.dtype)
    return w_s, torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)


def _scan_outs_grads(fn, args, seed, unaligned=False):
    """``fn``'s (last state, y) and the gradients of all six inputs of its
    scan from the same forward, given seeded cotangents of y: with a
    seeded cotangent of the last state, then without one (an input
    nothing reaches gets zeros).  ``unaligned``: the inputs one element
    off the 16-byte boundary."""
    xs = [(_unaligned(a.detach()) if unaligned else a.detach().clone()
           ).requires_grad_(True) for a in args]
    s, y = fn(*xs)
    w_s, w_y = _scan_cots(s, y, seed)
    out = []
    for outs, cots in (([s, y], [w_s, w_y]), ([y], [w_y])):
        grads = torch.autograd.grad(outs, xs, cots, allow_unused=True,
                                    retain_graph=not out)
        out.append([torch.zeros_like(x) if gr is None else gr
                    for x, gr in zip(xs, grads)])
    return (s.detach(), y.detach()), out


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


def _scan_record(k, way, route, src, r, dtype=torch.bfloat16) -> dict:
    """One scan route's record of the kernels line (``launches`` filled
    from the main path's phases); float32 routes' names end in ``_f32``."""
    tail = "_f32" if dtype == torch.float32 else ""
    return {"name": f"{k['name']}_{way}_{route}{tail}", "route": "cuda",
            "dtype": str(dtype).removeprefix("torch."),
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


def _bwd_sweep(kind, k, gen, shapes=None) -> dict:
    """The new backward route through autograd at ``shapes`` (B, T,
    width), by default B = 2, full width, T in :data:`SCAN_SWEEP_T`, and
    its main path's shape (:func:`_bwd_main_shape`), in every decay
    regime, with and without a
    cotangent of the last state: all six gradients finite, within
    ``SCAN_GRAD_TOL`` of autograd through the bf16 loop and
    ``SCAN_GRAD_F32_TOL`` of the loop in float32 on the same values (as a
    share of the largest).  Returns the worst shares by regime."""
    bf16, worst = torch.bfloat16, {}
    route = k["bwd_route"]
    if shapes is None:
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
            got = _scan_outs_grads(k["fn"], args, 5 + t)[1]
            if k["fn"].bwd_route_launches[route] != n0 + 2:
                fail(f"scan {kind} backward B={b} T={t} width={width}: "
                     f"the {route} route "
                     f"launched {k['fn'].bwd_route_launches[route] - n0} "
                     f"times, want 2")
            for f32, tol in ((False, SCAN_GRAD_TOL[bf16]),
                             (True, SCAN_GRAD_F32_TOL)):
                want = _scan_outs_grads(
                    k["plain"], [a.float() for a in args] if f32 else args,
                    5 + t)[1]
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


def _train_jamba_scan(k) -> dict:
    """The Mamba chunk route, forward and backward, at ``[train-jamba]``'s
    shape (:data:`TRAIN_JAMBA`'s B and T, Jamba's d_model), bf16, in every
    decay regime: the forward (the plan takes ``chunk``) with state and y
    no further from the loop in float32 than the bf16 loop is, the
    gradients as :func:`_bwd_sweep` holds them.  Draws from a generator of
    its own (seed 31), so the sweeps draw the inputs they drew before.
    Returns the forward's errors and the backward's worst shares by
    regime."""
    from repro_torch.configs import base as cbase
    gen = torch.Generator(device="cuda").manual_seed(31)
    b, t = TRAIN_JAMBA["batch"], TRAIN_JAMBA["seq_len"]
    width = cbase.get("jamba_1_5_large_398b").d_model
    fwd = {}
    for regime in SCAN_REGIMES:
        args = _scan_args("mamba", b, t, width, torch.bfloat16, gen, regime)
        if k["plan"](*args) != k["route"]:
            fail(f"scan mamba [train-jamba] shape {regime}: plan "
                 f"{k['plan'](*args)}, want {k['route']}")
        fwd[regime] = _against_float32(
            f"scan mamba {k['route']} [train-jamba] shape {regime}",
            k["new"](*args), args, k["plain"])
        del args
    _free()
    bwd = _bwd_sweep("mamba", k, gen, [(b, t, width)])
    return {"shape": [b, t, width], "fwd_err": fwd, "bwd_worst_share": bwd}


def _scan_backward(kind, k, gen, clock, dtype=torch.bfloat16) -> dict:
    """The backward at B = 2, T = 2048, one layer's width, in ``dtype``:
    in bf16 the new route's sweep first (:func:`_bwd_sweep`; float32 has
    its own, :func:`_f32_sweep`), then the new route and the step pair on
    the same inputs, each timed (CUDA events around eager calls) beside
    the loop (forward and autograd backward through it), its bound, the
    step-serial bound, and the workspace it allocates.  Returns both
    routes' records."""
    bf16, width, name = torch.bfloat16, k["width"], k["name"]
    route = k["bwd_route"]
    tol, elem = SCAN_GRAD_TOL[dtype], dtype.itemsize
    label = "bf16" if dtype == bf16 else "float32"
    t1 = time.perf_counter()
    worst = None
    if dtype == bf16:
        worst = _bwd_sweep(kind, k, gen)
        print(f"[scan] {name} backward, route {route}, bf16 B=2 "
              f"width={width}: all six gradients finite and within "
              f"{SCAN_GRAD_TOL[bf16]} of autograd through the bf16 loop and "
              f"{SCAN_GRAD_F32_TOL} of the loop in float32 (shares of the "
              f"largest) at every T in {SCAN_SWEEP_T} and at the main path's "
              f"B, T, width {_bwd_main_shape(kind)}, with and without a "
              f"cotangent of the last state; worst shares (bf16 loop / "
              f"float32 loop): " + "; ".join(
                  f"{r} {a:.3g} / {b:.3g}" for r, (a, b) in worst.items())
              + f" ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    args = _scan_args(kind, 2, 2048, width, dtype, gen)
    got = _scan_grads(k["fn"], args, 2)
    want = _scan_grads(k["plain"], args, 2)
    errs = [_scan_err(f"scan {kind} {label} backward gradient {i}", g, w, tol)
            for i, (g, w) in enumerate(zip(got, want))]
    rel = [x / w.float().abs().max().item() for x, w in zip(errs, want)]
    # the step pair on the same cotangents, against the same loop
    w_s, w_y = _scan_cots(args[5], args[0], 2)
    errs_step = [_scan_err(f"scan {kind} {label} backward step pair "
                           f"gradient {i}", g, w, tol)
                 for i, (g, w) in enumerate(zip(
                     k["bwd_step"](*args, w_s, w_y), want))]
    del want, w_s, w_y
    rel32 = None
    if dtype == bf16:
        want = _scan_grads(k["plain"], [a.float() for a in args], 2)
        rel32 = [_scan_err(f"scan {kind} backward gradient {i} against "
                           f"float32", g.float(), w, SCAN_GRAD_F32_TOL)
                 / w.abs().max().item()
                 for i, (g, w) in enumerate(zip(got, want))]
        del want
    del got
    _free()
    g = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        s, y = k["fn"](*args)
    ds = torch.randn(s.shape, generator=g, device="cuda")
    dy = torch.randn(y.shape, generator=g, device="cuda").to(dtype)
    del s, y
    # the step pair (the loop's roundings) against the new route
    new_g, step_g = k["bwd_new"](*args, ds, dy), k["bwd_step"](*args, ds, dy)
    pair = [_scan_err(f"scan {kind} {label} backward {route} against step, "
                      f"gradient {i}", a.float(), b.float(), tol)
            for i, (a, b) in enumerate(zip(new_g, step_g))]
    del new_g, step_g
    _free()
    # float32: the loop ran at this shape in the sweep, so no warm-up
    plain_ms = call_ms(lambda: _scan_grads(k["plain"], args, 4), reps=1,
                       warm=int(dtype == bf16))
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
                  **_scan_bound(kind, r, True, 2, 2048, width, clock, elem)}
    out[route].update(grad_max_abs_err=errs, grad_err_share_of_max=rel,
                      vs_step_max_abs_err=pair)
    if dtype == bf16:
        out[route].update(grad_err_share_of_max_vs_float32=rel32,
                          sweep_worst_share=worst)
    out["step"].update(max_abs_err=max(errs_step),
                       grad_max_abs_err=errs_step)
    new, step = out[route], out["step"]
    print(f"[scan] {name} backward {label} B=2 T=2048 width={width}: route "
          f"{route} max abs err vs autograd through the {label} loop "
          f"{max(errs):.3g} (by input, as a share of max: "
          + ", ".join(f"{x:.2g}" for x in rel)
          + ("; against the loop in float32 on the same values: "
             + ", ".join(f"{x:.2g}" for x in rel32) if rel32 else "") + ")")
    for r, rec in ((route, new), ("step", step)):
        print(f"[scan] {name} backward {label} B=2 T=2048, route {r}: "
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
    gain = step["ms"] / new["ms"]
    share = new["workspace_bytes"] / step["workspace_bytes"]
    # every step's float32 state: the workspace of a pair that kept them
    every = 2 * 2048 * width * (SCAN_HD if kind == "rwkv" else SCAN_N) * 4
    new.update(step_ratio=gain, workspace_share_of_step=share,
               workspace_share_of_every_state=new["workspace_bytes"] / every)
    step.update(workspace_share_of_every_state=step["workspace_bytes"]
                / every, every_state_bytes=every,
                bitwise_repeat=_bitwise_repeat(k["bwd_step"], *args, ds, dy))
    print(f"[scan] {name} backward {label} B=2 T=2048: route {route} "
          f"{new['ms'] * 1e3:.2f} us, step pair {step['ms'] * 1e3:.2f} us on "
          f"the same inputs ({gain:.2f}x the route's time); workspace "
          f"{new['workspace_bytes'] / 1e9:.4f} GB against "
          f"{step['workspace_bytes'] / 1e9:.4f} GB, shares of every step's "
          f"state ({every / 1e9:.4f} GB) "
          f"{new['workspace_share_of_every_state']:.4f} and "
          f"{step['workspace_share_of_every_state']:.4f}; the two routes' "
          f"gradients agree within {max(pair):.3g}; the step pair twice "
          f"on the same inputs bitwise {step['bitwise_repeat']}; "
          f"{time.perf_counter() - t1:.1f} s")
    if not step["bitwise_repeat"]:
        fail(f"scan {kind} {label} backward step pair: two runs differ")
    for r, rec in ((route, new), ("step", step)):
        if rec["workspace_share_of_every_state"] > SCAN_BWD_WS_SHARE[r]:
            print(f"[scan] {name} backward {label}: route {r}'s workspace "
                  f"past {SCAN_BWD_WS_SHARE[r]:.4g} of every step's state")
    del ds, dy, args
    _free()
    return out


def _bitwise_repeat(fn, *args) -> bool:
    """``fn(*args)`` twice: every output the same bit for bit."""
    first = fn(*args)
    return all(torch.equal(a, b) for a, b in zip(first, fn(*args)))


def _step_bwd_sweep(kind, k, gen) -> dict:
    """The step pair through autograd on what the chunked routes refuse
    (:data:`STEP_BWD_EDGES`: T = 1, tensors one element off the 16-byte
    boundary, Mamba's widths off the vector), in both dtypes, every decay
    regime, with and without a cotangent of the last state: the plan
    takes ``step``, each backward launches it once, all six gradients
    finite and within ``SCAN_GRAD_TOL`` of autograd through the loop in
    the same dtype (bf16 also within ``SCAN_GRAD_F32_TOL`` of the loop in
    float32 on the same values, plus the bf16 loop's own distance from
    it: the pair keeps the bf16 loop's roundings), and the entry twice on
    the same inputs bitwise.  Returns the worst shares of the largest by
    dtype and the cases run."""
    worst, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).removeprefix("torch.")
        w_loop = w_f32 = 0.0
        for regime in SCAN_REGIMES:
            for b, t, width, unal in STEP_BWD_EDGES[kind]:
                args = _scan_args(kind, b, t, width, dtype, gen, regime)
                if unal:
                    args = [_unaligned(a) for a in args]
                tag = (f"scan {kind} step backward {label} {regime} B={b} "
                       f"T={t} width={width}{' unaligned' if unal else ''}")
                with torch.no_grad():
                    s, y = k["fn"](*args)
                dy = torch.zeros_like(y)
                dy = _unaligned(dy) if unal else dy
                for ds in (s, None):
                    if k["bwd_plan"](*args, ds, dy) != "step":
                        fail(f"{tag}: plan {k['bwd_plan'](*args, ds, dy)}")
                w_s, w_y = _scan_cots(s, y, 7 + t)
                if unal:
                    w_s, w_y = _unaligned(w_s), _unaligned(w_y)
                if not _bitwise_repeat(k["bwd_step"], *args, w_s, w_y):
                    fail(f"{tag}: two runs differ")
                del s, y, dy, w_s, w_y
                n0 = k["fn"].bwd_route_launches["step"]
                got = _scan_outs_grads(k["fn"], args, 7 + t, unal)[1]
                if k["fn"].bwd_route_launches["step"] != n0 + 2:
                    fail(f"{tag}: the step pair launched "
                         f"{k['fn'].bwd_route_launches['step'] - n0} times, "
                         f"want 2")
                loop = _scan_outs_grads(k["plain"], args, 7 + t)[1]
                f32 = (_scan_outs_grads(k["plain"],
                                        [a.float() for a in args], 7 + t)[1]
                       if dtype == torch.bfloat16 else None)
                for j, (last, gs) in enumerate(zip(("with", "without"),
                                                   got)):
                    for i, (g, w) in enumerate(zip(gs, loop[j])):
                        err = _scan_err(f"{tag} {last} ds, gradient {i}",
                                        g.float(), w.float(),
                                        SCAN_GRAD_TOL[dtype])
                        w_loop = max(w_loop, err / max(
                            w.float().abs().max().item(), 1e-30))
                        if f32 is None:
                            continue
                        c = f32[j][i]
                        own = (w.float() - c).abs().max().item()
                        err = (g.float() - c).abs().max().item()
                        big = max(c.abs().max().item(), 1e-30)
                        if not torch.isfinite(g.float()).all() or \
                                err > SCAN_GRAD_F32_TOL * big + own:
                            fail(f"{tag} {last} ds, gradient {i}: {err} from "
                                 f"the float32 loop, past "
                                 f"{SCAN_GRAD_F32_TOL} of {big} and the bf16 "
                                 f"loop's own {own}")
                        w_f32 = max(w_f32, (err - own) / big)
                n += 1
                del got, loop, f32, args
            _free()
        worst[label] = (w_loop, w_f32)
    return {"worst_share": worst, "cases": n}


def _step_fwd_sweep(kind, k, gen) -> dict:
    """The step forward through the entry on what the chunked routes
    refuse (:data:`STEP_FWD_T` x :data:`STEP_FWD_EDGES`: T = 1, tensors one
    element off the 16-byte boundary, Mamba's widths off the vector), in
    both dtypes and every decay regime: the plan takes ``step`` and the
    call launches it once; the last state is the loop's bit for bit and y
    within ``SCAN_TOL`` of it; y is bit for bit the plain version that sums
    in the kernel's order (``ref.rwkv6_scan_step`` at T >= 2, the decode
    kernel's at T = 1 being another; ``ref.mamba_scan_step``); and the
    entry twice on the same inputs gives the same bits.  Returns the worst
    share of the largest of y's error against the loop by dtype, and the
    cases run."""
    from repro_torch.kernels import ref
    order = ref.rwkv6_scan_step if kind == "rwkv" else ref.mamba_scan_step
    worst, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        label = str(dtype).removeprefix("torch.")
        w_y = 0.0
        for regime in SCAN_REGIMES:
            for t in STEP_FWD_T:
                for width, unal in STEP_FWD_EDGES[kind](t):
                    args = _scan_args(kind, 2, t, width, dtype, gen, regime)
                    if unal:
                        args = [_unaligned(a) for a in args]
                    tag = (f"scan {kind} step forward {label} {regime} T={t} "
                           f"width={width}{' unaligned' if unal else ''}")
                    if k["plan"](*args) != "step":
                        fail(f"{tag}: plan {k['plan'](*args)}")
                    n0 = k["fn"].route_launches["step"], k["fn"].launches
                    with torch.no_grad():
                        got = k["fn"](*args)
                    n1 = k["fn"].route_launches["step"], k["fn"].launches
                    if (n1[0] - n0[0], n1[1] - n0[1]) != (1, 1):
                        fail(f"{tag}: {n1[1] - n0[1]} launches, "
                             f"{n1[0] - n0[0]} by step, want 1")
                    again = k["step"](*args)
                    want = k["plain"](*args)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        fail(f"{tag}: two runs differ")
                    if not torch.equal(got[0], want[0]):
                        fail(f"{tag}: state not bitwise the loop's")
                    err = _scan_err(f"{tag} y", got[1], want[1],
                                    SCAN_TOL[dtype])
                    w_y = max(w_y, err / max(
                        want[1].float().abs().max().item(), 1e-30))
                    if kind == "mamba" or t > 1:
                        if not torch.equal(got[1], order(*args)[1]):
                            fail(f"{tag}: y not bitwise the plain version "
                                 f"in the kernel's order")
                    n += 1
                    del args, got, again, want
            _free()
        worst[label] = w_y
    return {"worst_y_share": worst, "cases": n}


def _f32_main_shapes(kind) -> list:
    """B, T, width and head width of the float32 routes on their main
    path, ``[train-small]``: the rwkv6_7b smoke config (d_model 64 in
    heads of 16) and the jamba smoke config (64 Mamba channels) at
    :data:`TRAIN_SMALL`'s batch, at its T and at T 2, 17 and 65 (the
    chunk's edges at that width)."""
    from repro_torch.configs import base as cbase
    cfg = cbase.smoke(cbase.get(
        "rwkv6_7b" if kind == "rwkv" else "jamba_1_5_large_398b"))
    return [(TRAIN_SMALL["batch"], t, cfg.d_model, cfg.hd)
            for t in (2, TRAIN_SMALL["seq_len"], 17, 65)]


def _f32_sweep(kind, k, gen, shapes) -> dict:
    """The float32 routes (RWKV-6 ``chunked``, Mamba ``chunk``) through
    autograd at ``shapes`` (B, T, width, RWKV-6 head width), in every
    decay regime: the last state within ``SCAN_STATE_TOL`` and y within
    ``SCAN_TOL`` of the float32 loop, each gradient within
    ``SCAN_GRAD_TOL`` of autograd through it (as a share of the largest),
    with and without a cotangent of the last state; the plans take the
    routes, and each call launches the forward route once and the
    backward route twice.  Beside each, the float32 loop's own error
    against the loop run in float64 (the gradients' below T =
    ``SCAN_SWEEP_T_F32[-1]``).  Returns the worst errors by regime, state
    / y / gradients: the route's and the loop's as shares of the largest
    (``route``, ``loop``), and the route's max abs error
    (``route_abs``)."""
    f32, route = torch.float32, k["route"]
    out = {}
    for regime in SCAN_REGIMES:
        worst = {x: [0.0, 0.0, 0.0] for x in ("route", "loop", "route_abs")}
        for b, t, width, hd in shapes:
            args = _scan_args(kind, b, t, width, f32, gen, regime, hd)
            tag = (f"scan {kind} {route} float32 {regime} B={b} T={t} "
                   f"width={width}" + (f" hd={hd}" if kind == "rwkv" else ""))
            dy = torch.zeros_like(args[0])
            if k["plan"](*args) != route or any(
                    k["bwd_plan"](*args, ds, dy) != k["bwd_route"]
                    for ds in (args[5], None)):
                fail(f"{tag}: plans {k['plan'](*args)} / "
                     f"{k['bwd_plan'](*args, args[5], dy)}, want {route}")
            del dy
            n0 = (k["fn"].route_launches[route],
                  k["fn"].bwd_route_launches[k["bwd_route"]])
            got, got_g = _scan_outs_grads(k["fn"], args, 7 + t)
            n1 = (k["fn"].route_launches[route],
                  k["fn"].bwd_route_launches[k["bwd_route"]])
            if (n1[0] - n0[0], n1[1] - n0[1]) != (1, 2):
                fail(f"{tag}: launched {n1[0] - n0[0]} forward, "
                     f"{n1[1] - n0[1]} backward by the route, want 1, 2")
            want, want_g = _scan_outs_grads(k["plain"], args, 7 + t)
            wide = [a.double() for a in args]
            if t < SCAN_SWEEP_T_F32[-1]:
                d64, d64_g = _scan_outs_grads(k["plain"], wide, 7 + t)
            else:
                with torch.no_grad():
                    d64, d64_g = k["plain"](*wide), (None, None)
            for i, tol in enumerate((SCAN_STATE_TOL, SCAN_TOL[f32])):
                what = ("state", "y")[i]
                err = _scan_err(f"{tag} {what}", got[i], want[i], tol)
                scale = want[i].abs().max().item()
                worst["route"][i] = max(worst["route"][i], err / scale)
                worst["route_abs"][i] = max(worst["route_abs"][i], err)
                own = (want[i].double() - d64[i]).abs().max().item()
                worst["loop"][i] = max(worst["loop"][i],
                                       own / d64[i].abs().max().item())
            for last, gs, ws, w64 in zip(("with", "without"), got_g, want_g,
                                         d64_g):
                for i, (g, w) in enumerate(zip(gs, ws)):
                    err = _scan_err(f"{tag} {last} ds, gradient {i}", g, w,
                                    SCAN_GRAD_TOL[f32])
                    big = w.abs().max().item()
                    if big == 0:  # nothing reaches it: zeros all round
                        continue
                    worst["route"][2] = max(worst["route"][2], err / big)
                    worst["route_abs"][2] = max(worst["route_abs"][2], err)
                    if w64 is not None:
                        x = w64[i]
                        worst["loop"][2] = max(
                            worst["loop"][2], (w.double() - x).abs().max()
                            .item() / x.abs().max().item())
            del args, got, got_g, want, want_g, d64, d64_g, wide
        _free()
        out[regime] = worst
    return out


def _scan_prefill_f32(kind, k, gen, clock, b) -> tuple:
    """Float32 prefill (b x 512, one layer's width) by the new route and
    by the step route on the same inputs: the new route's state and y
    within ``SCAN_STATE_TOL`` / ``SCAN_TOL`` of the float32 loop, the
    step route's state bitwise the loop's; each timed beside its bound,
    the step-serial bound and the loop, and the float32 loop's own error
    against the loop in float64 beside.  Returns both routes' records."""
    f32, width, name, route = torch.float32, k["width"], k["name"], k["route"]
    args = _scan_args(kind, b, 512, width, f32, gen)
    plain_ms = call_ms(lambda: k["plain"](*args), reps=2, warm=1)
    want = k["plain"](*args)
    w64 = k["plain"](*[a.double() for a in args])
    own = [(w.double() - x).abs().max().item() for w, x in zip(want, w64)]
    del w64
    tols = (SCAN_STATE_TOL, SCAN_TOL[f32])
    got = k["new"](*args)
    errs = [_scan_err(f"scan {kind} prefill float32 {route} {what}", g, w,
                      tol)
            for g, w, tol, what in zip(got, want, tols, ("state", "y"))]
    got = k["step"](*args)
    torch.cuda.synchronize()
    bitwise = torch.equal(got[0], want[0])
    if not bitwise:
        fail(f"scan {kind} prefill float32 step: state not bitwise the "
             f"loop's")
    errs_s = [_scan_err(f"scan {kind} prefill float32 step {what}", g, w,
                        tol)
              for g, w, tol, what in zip(got, want, tols, ("state", "y"))]
    del got, want
    shape = [b, 512, width]
    new = {"ms": device_ms(lambda: k["new"](*args), reps=50, replays=3),
           "plain_ms": plain_ms, "max_abs_err": errs[1],
           "state_max_abs_err": errs[0],
           "float32_loop_err_vs_float64": {"state": own[0], "y": own[1]},
           "err_against": "the float32 loop", "shape": shape,
           **_scan_bound(kind, route, False, b, 512, width, clock, 4)}
    step = {"ms": device_ms(lambda: k["step"](*args), reps=20, replays=3),
            "plain_ms": plain_ms, "max_abs_err": errs_s[1],
            "state_max_abs_err": errs_s[0], "state_bitwise": bitwise,
            "shape": shape,
            **_scan_bound(kind, "step", False, b, 512, width, clock, 4)}
    del args
    _free()
    _scan_line(f"float32 prefill, route {route}", name, b, 512, width, new,
               f"against the float32 loop, state {errs[0]:.3g} and y "
               f"{errs[1]:.3g} (the float32 loop's own against the loop in "
               f"float64: {own[0]:.3g} and {own[1]:.3g})")
    _scan_line("float32 prefill, route step", name, b, 512, width, step,
               f"max abs err vs the float32 loop {errs_s[1]:.3g} (state "
               f"bitwise {bitwise})")
    gain = step["ms"] / new["ms"]
    new["step_ratio"] = gain
    print(f"[scan] {name} float32 prefill: route {route} "
          f"{new['ms'] * 1e3:.2f} us, route step {step['ms'] * 1e3:.2f} us "
          f"on the same inputs, {gain:.2f}x")
    if gain < SCAN_FWD_GAIN[kind]:
        print(f"[scan] {name} float32 prefill: route {route} short of "
              f"{SCAN_FWD_GAIN[kind]:g}x the step route's speed "
              f"({gain:.2f}x)")
    return new, step


def phase_scan() -> list:
    """The scans' kernels against their plain loops on the card, route by
    route.  First float32 at a small odd shape (T = 37, forward and
    backward by the planned routes).  Then the new routes (RWKV-6
    chunked, Mamba chunk) at T in :data:`SCAN_SWEEP_T` and three decay
    regimes, at full width (B = 2): in bf16 against the loop run in
    float32 on the same values (state and y finite and no further from it
    than the bf16 loop is); in float32 (:func:`_f32_sweep`, T in
    :data:`SCAN_SWEEP_T_F32`, forward and backward) against the float32
    loop at its tolerances, and so again at the float32 routes' own main
    path's shapes (:func:`_f32_main_shapes`: ``[train-small]``'s heads of
    16 and 64 Mamba channels).  Then the main path's shapes, one RWKV-6-7B
    layer (64 heads of 64) and one Jamba Mamba layer (8192 channels, N =
    16), in bf16 and in float32: prefill (8 x 512) by the new route and by
    the step route on the same inputs, the step route's state bitwise the
    loop's; decode (T = 1, bf16) by RWKV-6's step route and Mamba's decode
    route, both bitwise, beside Mamba's step kernel at T = 1; the backward
    (B = 2, T = 2048) by the new route and by the step pair
    (:func:`_scan_backward`); the step pairs' and the step forwards' edge
    sweeps (:func:`_step_bwd_sweep`, :func:`_step_fwd_sweep`).  Each timed
    beside its route's bound, the
    step-serial bound and its plain loop (no library call computes the
    recurrence); the step forwards' beside their counted-instruction
    floors (``[build]``'s SASS counts).  Returns the kernels line's
    records, one a route and dtype (RWKV-6's step route two: decode, and
    ``step_t2``, the kernel of T >= 2; ``launches`` filled from the main
    path's phases)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(25)
    kinds = _scan_kinds()
    clock = _sm_clock_hz()
    saved = _scan_launches(), {n: (dict(c.route_launches),
                                   dict(c.bwd_route_launches))
                               for n, c in _scan_counters().items()}
    f32 = torch.float32
    for kind, k in kinds.items():
        args = _scan_args(kind, 2, 37, 256, f32, gen)
        if k["plan"](*args) != k["route"]:
            fail(f"scan {kind} float32: plan {k['plan'](*args)}, want "
                 f"{k['route']}")
        for got, want, what in zip(k["fn"](*args), k["plain"](*args),
                                   ("state", "y")):
            _scan_err(f"scan {kind} float32 {what}", got, want,
                      SCAN_STATE_TOL if what == "state" else
                      SCAN_TOL[f32])
        for i, (got, want) in enumerate(zip(_scan_grads(k["fn"], args, 1),
                                            _scan_grads(k["plain"], args,
                                                        1))):
            _scan_err(f"scan {kind} float32 gradient {i}", got, want,
                      SCAN_GRAD_TOL[f32])
    print(f"[scan] float32, T = 37 (chunked / chunk routes): both scans' "
          f"states, outputs and the gradients of all six inputs agree with "
          f"the plain loops (rtol {SCAN_STATE_TOL} / {SCAN_TOL[f32]} / "
          f"{SCAN_GRAD_TOL[f32]} of max)")
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
    f32_worst, f32_main = {}, {}
    for kind, k in kinds.items():
        main = _f32_main_shapes(kind)
        for where, shapes in (
                (f"B=2 width={k['width']}, T in {SCAN_SWEEP_T_F32}",
                 [(2, t, k["width"], SCAN_HD) for t in SCAN_SWEEP_T_F32]),
                (f"the main path's B, T, width, head width {main}", main)):
            t1 = time.perf_counter()
            w = _f32_sweep(kind, k, gen, shapes)
            if shapes is main:
                f32_main[kind] = {"shapes": [list(x) for x in main],
                                  "worst": w}
            else:
                f32_worst[kind] = w
            print(f"[scan] {k['name']} float32 routes {k['route']} / "
                  f"{k['bwd_route']} (forward / backward), {where}, with and "
                  f"without a cotangent of the last state: state, y and the "
                  f"six gradients within {SCAN_STATE_TOL} / {SCAN_TOL[f32]} "
                  f"/ {SCAN_GRAD_TOL[f32]} of the float32 loop; worst shares "
                  f"of the largest, route against the float32 loop (the "
                  f"float32 loop's own against the loop in float64; its "
                  f"gradients' at T < {SCAN_SWEEP_T_F32[-1]}), state / y / "
                  f"gradients: " + "; ".join(
                      f"{r} " + " / ".join(
                          f"{a:.3g} ({b:.3g})" for a, b in zip(x["route"],
                                                              x["loop"]))
                      for r, x in w.items())
                  + f" ({time.perf_counter() - t1:.1f} s)")
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
               **_scan_bound(kind, k["route"], False, b, 512, width, clock,
                             2)}
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
                **_scan_bound(kind, "step", False, b, 512, width, clock, 2)}
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
        new_f, step_f = _scan_prefill_f32(kind, k, gen, clock, b)
        # the worst errors at the main path's shapes: y forward, the
        # gradients backward
        main_w = f32_main[kind]["worst"].values()
        new_f.update(sweep_worst_share=f32_worst[kind],
                     main_path_sweep=f32_main[kind],
                     main_path_max_abs_err=max(w["route_abs"][1]
                                               for w in main_w))
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
                **_scan_bound(kind, route, False, b, 1, width, clock, 2)}
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
        # backward: the new route and the step pair on the same inputs, in
        # bf16 and in float32
        back = _scan_backward(kind, k, gen, clock)
        back_f = _scan_backward(kind, k, gen, clock, f32)
        back_f[k["bwd_route"]].update(
            main_path_sweep=f32_main[kind],
            main_path_max_abs_err=max(w["route_abs"][2] for w in main_w))
        t1 = time.perf_counter()
        edges = _step_bwd_sweep(kind, k, gen)
        back["step"]["edge_sweep"] = back_f["step"]["edge_sweep"] = edges
        print(f"[scan] {name} step pair, edge sweep ({edges['cases']} cases: "
              f"(B, T, width, unaligned) in {STEP_BWD_EDGES[kind]}, both "
              f"dtypes, three decay regimes, with and without a cotangent of "
              f"the last state): the plan takes it, one launch a backward, "
              f"two runs bitwise, all six gradients finite and within "
              f"{SCAN_GRAD_TOL[f32]} (float32) / {SCAN_GRAD_TOL[bf16]} (bf16) "
              f"of autograd through the loop; worst shares of the largest "
              f"(against the same dtype's loop / bf16 past the bf16 loop's "
              f"own distance from the float32 loop): " + "; ".join(
                  f"{d} {a:.3g} / {b:.3g}"
                  for d, (a, b) in edges["worst_share"].items())
              + f" ({time.perf_counter() - t1:.1f} s)")
        t1 = time.perf_counter()
        # its own seeded inputs: the other sweeps draw theirs as before
        fwd_edges = _step_fwd_sweep(
            kind, k, torch.Generator(device="cuda").manual_seed(30))
        print(f"[scan] {name} step forward, edge sweep ({fwd_edges['cases']} "
              f"cases: T in {STEP_FWD_T}, B = 2, width {k['width']} one "
              f"element off the 16-byte boundary"
              + (", 8190 and 30" if kind == "mamba" else "")
              + ", both dtypes, three decay regimes): the plan takes it, one "
              f"launch a call, the state bitwise the loop's, y bitwise the "
              f"plain version in the kernel's order"
              + (" (T >= 2)" if kind == "rwkv" else "")
              + f" and within {SCAN_TOL[f32]} (float32) / {SCAN_TOL[bf16]} "
              f"(bf16) of the loop, two runs bitwise; worst share of the "
              f"largest, y against the loop: " + "; ".join(
                  f"{d} {w:.3g}" for d, w in fwd_edges["worst_y_share"].items())
              + f" ({time.perf_counter() - t1:.1f} s)")
        if kind == "mamba":
            t1 = time.perf_counter()
            jamba = _train_jamba_scan(k)
            new["train_jamba_shape"] = back[k["bwd_route"]][
                "train_jamba_shape"] = jamba
            print(f"[scan] {name} {k['route']} forward and backward at "
                  f"[train-jamba]'s shape (B, T, width {jamba['shape']}, "
                  f"bf16, three decay regimes): the plans take chunk; state "
                  f"and y no further from the loop in float32 than the bf16 "
                  f"loop, state / y (the bf16 loop's own): " + "; ".join(
                      f"{r} {e['state'][0]:.3g} ({e['state'][1]:.3g}) / "
                      f"{e['y'][0]:.3g} ({e['y'][1]:.3g})"
                      for r, e in jamba["fwd_err"].items())
                  + f"; all six gradients within {SCAN_GRAD_TOL[bf16]} of "
                  f"autograd through the bf16 loop and {SCAN_GRAD_F32_TOL} "
                  f"of the loop in float32, with and without a cotangent of "
                  f"the last state, worst shares (bf16 loop / float32 loop): "
                  + "; ".join(f"{r} {a:.3g} / {c:.3g}" for r, (a, c) in
                              jamba["bwd_worst_share"].items())
                  + f" ({time.perf_counter() - t1:.1f} s)")
        src = "rwkv6_scan.cu" if kind == "rwkv" else "mamba_scan.cu"
        step.update(edge_sweep=fwd_edges, **_step_fwd_floor(
            kind, bf16, step["shape"], clock))
        step_f.update(edge_sweep=fwd_edges, **_step_fwd_floor(
            kind, f32, step_f["shape"], clock))
        bwd_route = k["bwd_route"]
        records += [
            _scan_record(k, "fwd", k["route"], k["src"], new),
            _scan_record(k, "fwd", k["route"], k["src"], new_f, f32)]
        if "decode" in decode:
            records.append(_scan_record(k, "fwd", "decode", src,
                                        decode["decode"]))
        if kind == "rwkv":
            # decode (the main path's step launches) and T >= 2 are two
            # kernels behind the step entry
            records += [
                _scan_record(k, "fwd", "step", src,
                             {**decode["step"], "kernel": "rwkv6_fwd_kernel"}),
                _scan_record(k, "fwd", "step_t2", src, step),
                _scan_record(k, "fwd", "step_t2", src, step_f, f32)]
        else:
            records += [
                _scan_record(k, "fwd", "step", src,
                             {**step, "decode": decode["step"]}),
                _scan_record(k, "fwd", "step", src, step_f, f32)]
        records += [
            _scan_record(k, "bwd", bwd_route, k["bwd_src"], back[bwd_route]),
            _scan_record(k, "bwd", bwd_route, k["bwd_src"], back_f[bwd_route],
                         f32),
            _scan_record(k, "bwd", "step", src, back["step"]),
            _scan_record(k, "bwd", "step", src, back_f["step"], f32)]
    for n, c in _scan_counters().items():
        c.launches, c.bwd_launches = saved[0][n]
        c.route_launches, c.bwd_route_launches = saved[1][n]
    print(f"[scan] SM clock {clock / 1e9:.3f} GHz (max, nvidia-smi) for the "
          f"exp bound; {time.perf_counter() - t_phase:.1f} s")
    return records


# ---------------------------------------------------------------------------
# chunked attention: the reference's device loop over key chunks
# ---------------------------------------------------------------------------

#: [attn]'s edge sweep: query and key lengths (Tk past a tile and past a
#: chunk of 512, so the last tile is partial; Tq on both sides of the
#: split route's threshold), head widths (every config's), and (causal,
#: q_offset)
ATTN_TQ = (1, 7, 256, 1500)
ATTN_TK = (1, 9, 512, 513, 1024, 1500)
ATTN_D = (16, 64, 112, 128, 160)
ATTN_MASKS = ((False, 0), (False, 37), (True, 0), (True, 37))
#: float32 tolerances, of max|want|: the output, and the gradients (of the
#: largest of the call's three, since dq and dk vanish where a row has one
#: live key and leave only the float32 rounding of dP - D)
ATTN_F32_TOL = {"out": 1e-5, "grad": 1e-4}
#: the main paths' shapes, bf16: B, H, Tq, Tk, d, causal, backward too
#: (Kimi-K2 and StableLM-12B train at head widths 112 and 160, on the tile
#: routes since their widths are padded to whole chunks; Jamba at full
#: width, [train-jamba], at d 128 over 2 x 1024 tokens; Jamba's smoke
#: config in bf16, [train-ssm]'s second run, at d 16 on the head route)
ATTN_PATHS = {
    "whisper-encoder": (8, 16, 1500, 1500, 64, False, False),
    "whisper-cross-prefill": (8, 16, 512, 1500, 64, False, False),
    "whisper-cross-decode": (8, 16, 1, 1500, 64, False, False),
    "llama-cross-prefill": (8, 64, 512, 1024, 128, False, False),
    "llama-cross-decode": (8, 64, 1, 1024, 128, False, False),
    "phi4-train": (8, 24, 256, 256, 128, True, True),
    "grok-train": (8, 48, 256, 256, 128, True, True),
    "kimi-train": (8, 64, 256, 256, 112, True, True),
    "stablelm-train": (8, 32, 256, 256, 160, True, True),
    "jamba-train": (2, 64, 1024, 1024, 128, True, True),
    "jamba-smoke-train": (2, 4, 64, 64, 16, True, True),
}
#: the split / tile threshold's sweep: the two cross-attention shapes
#: (B, H, Tk, d) at these query counts
ATTN_THRESHOLD_TQ = (1, 2, 4, 8)
ATTN_THRESHOLD_SHAPES = ((8, 16, 1500, 64), (8, 64, 1024, 128))
#: the float32 entries' shape: [train-small]'s smoke configs (2 x 16
#: tokens, 4 heads of 16, causal)
ATTN_SMOKE = (2, 4, 16, 16, 16, True, True)
#: the head route's edge sweep through the entry: every Tq against every
#: Tk (one, either side of a 16-row tile, the smoke encoder's 24, the
#: limit of 64 and one under it), float32 and bf16, ATTN_MASKS
ATTN_HEAD_T = (1, 2, 15, 16, 17, 24, 63, 64)
#: the lengths at which [attn] times the head route against the routes it
#: replaced, up to its limit (chunked_attention.HEAD_MAX_T)
ATTN_HEAD_LIMIT_T = (16, 32, 48, 64)
#: kernel-name fragments of the chunked-attention kernels (the mma and
#: simt routes', the tile and split routes', the head route's)
ATTN_KERNELS = ("attn_fwd_kernel", "attn_delta_kernel", "attn_bwd_kv_kernel",
                "attn_bwd_q_kernel", "attn_tile_fwd_kernel",
                "attn_split_kernel", "attn_combine_kernel",
                "attn_stats_kernel", "attn_kv_tile_kernel",
                "attn_q_tile_kernel", "attn_head_fwd_kernel",
                "attn_head_bwd_kernel")
#: routes no main path takes since the head route: their records are
#: timed on the main paths' inputs beside it and listed as baselines
ATTN_BASELINES = ("mma", "simt")
#: the kernels line's records of the routes: (way, route) -> the record's
#: name, its source, its main path's shape and the other shapes it takes
#: (a baseline route's: the shape it is timed at beside the head route)
ATTN_RECORDS = {
    ("fwd", "head"): ("chunked_attention_fwd_head", "head", "smoke",
                      ["jamba-smoke-train"]),
    ("bwd", "head"): ("chunked_attention_bwd_head", "head", "smoke",
                      ["jamba-smoke-train"]),
    ("fwd", "tile"): ("chunked_attention_fwd_tile_bf16", "sm90",
                      "whisper-encoder", ["whisper-cross-prefill",
                                          "llama-cross-prefill",
                                          "phi4-train", "grok-train",
                                          "kimi-train", "stablelm-train",
                                          "jamba-train"]),
    ("fwd", "split"): ("chunked_attention_fwd_split_bf16", "sm90",
                       "whisper-cross-decode", ["llama-cross-decode"]),
    ("fwd", "mma"): ("chunked_attention_fwd_mma_bf16", "",
                     "jamba-smoke-train", []),
    ("fwd", "simt"): ("chunked_attention_fwd_f32", "", "smoke", []),
    ("bwd", "tile"): ("chunked_attention_bwd_tile_bf16", "bwd_sm90",
                      "phi4-train", ["grok-train", "kimi-train",
                                     "stablelm-train", "jamba-train"]),
    ("bwd", "mma"): ("chunked_attention_bwd_mma_bf16", "",
                     "jamba-smoke-train", []),
    ("bwd", "simt"): ("chunked_attention_bwd_f32", "", "smoke", []),
}


def _attn_counts() -> tuple:
    from repro_torch.kernels import chunked_attention as ca
    return ca.chunked_attention.launches, ca.chunked_attention.bwd_launches


def _attn_routes() -> tuple:
    """Copies of the launches by route, forward and backward."""
    from repro_torch.kernels import chunked_attention as ca
    return (dict(ca.chunked_attention.route_launches),
            dict(ca.chunked_attention.bwd_route_launches))


def _reset_attn() -> None:
    from repro_torch.kernels import chunked_attention as ca
    ca.chunked_attention.launches = 0
    ca.chunked_attention.bwd_launches = 0
    for counts in (ca.chunked_attention.route_launches,
                   ca.chunked_attention.bwd_route_launches):
        for route in counts:
            counts[route] = 0


@contextlib.contextmanager
def _no_plain_attention():
    """The plain attention loop fails if a CUDA tensor reaches it inside
    the block: a CUDA path must launch the kernels.  Yields a count of
    its calls on CPU tensors (``["cpu"]``)."""
    from repro_torch.kernels import ref
    plain = ref.chunked_attention
    calls = {"cpu": 0}

    def guarded(q, *args, **kw):
        if q.is_cuda:
            fail("a CUDA tensor reached the plain attention loop")
        calls["cpu"] += 1
        return plain(q, *args, **kw)

    ref.chunked_attention = guarded
    try:
        yield calls
    finally:
        ref.chunked_attention = plain


@contextlib.contextmanager
def _plain_attention():
    """The models' chunked attention as its plain loop inside the block,
    on CUDA tensors too: the yardstick the kernels' waves are held to."""
    import types
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    saved = layers.attention
    layers.attention = types.SimpleNamespace(
        chunked_attention=ref.chunked_attention)
    try:
        yield
    finally:
        layers.attention = saved


def _attn_inputs(b, h, tq, tk, d, dtype, gen):
    """Seeded q, k, v and an output cotangent on the card."""
    def f(t):
        return torch.randn((b, h, t, d), generator=gen,
                           device="cuda").to(dtype)
    return f(tq), f(tk), f(tk), f(tq)


def _attn_run(fn, q, k, v, dout, causal, q_offset, grads=True):
    """The output and (``grads``) the gradients of q, k and v given
    ``dout``, through ``fn`` (the entry or the plain loop)."""
    xs = [t.detach().clone().requires_grad_(grads) for t in (q, k, v)]
    with torch.set_grad_enabled(grads):
        out = fn(*xs, causal=causal, q_offset=q_offset)
    if not grads:
        return [out]
    return [out.detach()] + list(torch.autograd.grad(out, xs, dout))


def _attn_loop(q, k, v, *, causal, q_offset):
    from repro_torch.kernels import ref
    return ref.chunked_attention(q, k, v, causal=causal, q_offset=q_offset)


def _attn_mma(q, k, v, dout, causal, q_offset, grads=True):
    """The ``mma`` route (``csrc/chunked_attention.cu``'s bf16 bodies) on
    the same inputs: the output and the gradients of q, k and v."""
    from repro_torch.kernels import chunked_attention as ca
    out, lse = ca.mma_fwd(q, k, v, causal, q_offset)
    if not grads:
        return [out]
    return [out, *ca.mma_bwd(q, k, v, out, dout, lse, causal, q_offset)]


def _attn_held(tag, got, q, k, v, dout, causal, q_offset, grads) -> dict:
    """``got`` (output and gradients) against the plain loop: float32
    within :data:`ATTN_F32_TOL`; bf16 against the loop run in float32 on
    the same values, no further from it than the bf16 loop is plus one
    bf16 ulp of max|want| (of the largest gradient for the gradients).
    Returns, per output, the error and its allowance."""
    want = _attn_run(_attn_loop, q.float(), k.float(), v.float(),
                     dout.float(), causal, q_offset, grads)
    bf16 = q.dtype == torch.bfloat16
    loop = _attn_run(_attn_loop, q, k, v, dout, causal, q_offset,
                     grads) if bf16 else None
    names = ("out", "dq", "dk", "dv")[:len(got)]
    g_scale = max((w.abs().max().item() for w in want[1:]), default=0.0)
    out = {}
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        if g.shape != w.shape or g.dtype != q.dtype or \
                not torch.isfinite(g.float()).all():
            fail(f"{tag} {name}: {tuple(g.shape)} {g.dtype}, want "
                 f"{tuple(w.shape)} {q.dtype}, finite")
        scale = w.abs().max().item() if name == "out" else g_scale
        err = (g.float() - w).abs().max().item()
        if bf16:
            own = (loop[i].float() - w).abs().max().item()
            allow = own + 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)
        else:
            own = None
            allow = ATTN_F32_TOL["out" if name == "out" else "grad"] * scale
        if err > allow:
            fail(f"{tag} {name}: {err} from the float32 loop, past "
                 f"{allow} (the bf16 loop's own {own})")
        out[name] = {"err": err, "allow": allow, "bf16_loop_err": own}
    return out


def _attn_check(tag, q, k, v, dout, causal, q_offset, grads=True) -> dict:
    """The kernels of the planned routes (through the entry and autograd)
    against the plain loop (:func:`_attn_held`), and twice: the two runs
    bitwise equal."""
    from repro_torch.kernels import chunked_attention as ca
    got = _attn_run(ca.chunked_attention, q, k, v, dout, causal, q_offset,
                    grads)
    again = _attn_run(ca.chunked_attention, q, k, v, dout, causal, q_offset,
                      grads)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{tag}: two runs differ")
    return _attn_held(tag, got, q, k, v, dout, causal, q_offset, grads)


def _attn_pairs(b, h, tq, tk, causal, q_offset) -> int:
    """Live (query, key) pairs of one call."""
    if not causal:
        return b * h * tq * tk
    i = np.arange(tq)
    return b * h * int(np.minimum(tk, q_offset + i + 1).sum())


def _attn_bound(b, h, tq, tk, d, causal, bwd, dtype, clock) -> dict:
    """The least time of one call: the larger of the bytes over 3.35 TB/s
    (each input read once, each output written once), the products'
    operations over the dtype's peak (bf16 tensor cores 989 TFLOP/s;
    float32 67) and the exponentials at 16 a clock an SM.  The live
    pairs count: forward q·k and p·v (4 d operations a pair), one exp a
    pair, q, k, v in and the output and log-sum-exp out; backward the
    recomputed q·k and dO·v, dS k, dSᵀ q, pᵀ dO (10 d a pair), one exp a
    pair, q, k, v, out, dO and the log-sum-exp in and dq, dk, dv out."""
    e = 2 if dtype == torch.bfloat16 else 4
    pairs = _attn_pairs(b, h, tq, tk, causal, 0)
    ops = (10 if bwd else 4) * pairs * d
    rows_q, rows_k = b * h * tq * d, b * h * tk * d
    nbytes = (e * (4 * rows_q + 4 * rows_k) + 4 * b * h * tq if bwd
              else e * (2 * rows_q + 2 * rows_k) + 4 * b * h * tq)
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": ops / rate * 1e3,
             "exps": pairs / (SFU_EXP_PER_CLOCK * N_SM * clock) * 1e3}
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": "bytes" if by == "bytes"
            else "operations", "bound_kind": by, "ops": ops, "exps": pairs,
            "bytes": nbytes, "bound_terms_ms": terms}


def _attn_times(q, k, v, dout, causal, bwd) -> dict:
    """Device ms a launch by CUDA-graph replay: the planned route's kernel
    (``fwd_route``), the ``mma`` route on the same inputs, the plain
    loop, and ``scaled_dot_product_attention`` on the same inputs (the
    library column only); with ``bwd`` the same for the backward (the
    plain backward ``ref.chunked_attention_bwd``, SDPA's backward as
    autograd's backward of one SDPA forward, by :func:`queued_ms`)."""
    import torch.nn.functional as F
    from repro_torch.kernels import chunked_attention as ca
    from repro_torch.kernels import ref
    big = q.numel() * k.shape[2] // q.shape[3] > 2 ** 27
    reps = 10 if big else 50
    is_causal = causal  # q_offset 0 and Tq = Tk on the causal paths
    route = ca.attn_plan(q, k, v, causal, 0)
    new = ca._FWD[route]
    r = {"fwd_route": route,
         "fwd_ms": device_ms(lambda: new(q, k, v, causal, 0), reps=reps,
                             replays=3),
         "fwd_mma_ms": device_ms(lambda: ca.mma_fwd(q, k, v, causal, 0),
                                 reps=reps, replays=3),
         "fwd_plain_ms": device_ms(lambda: ref.chunked_attention(
             q, k, v, causal=causal), reps=max(2, reps // 5), replays=2),
         "fwd_library_ms": device_ms(lambda: F.scaled_dot_product_attention(
             q, k, v, is_causal=is_causal), reps=reps, replays=3)}
    if not bwd:
        return r
    out, lse = ca.chunked_attention_fwd(q, k, v, causal, 0)
    broute = ca.attn_bwd_plan(q, k, v, out, dout, causal, 0)
    bnew = ca._BWD[broute]
    r["bwd_route"] = broute
    r["bwd_ms"] = device_ms(lambda: bnew(q, k, v, out, dout, lse, causal, 0),
                            reps=reps, replays=3)
    r["bwd_mma_ms"] = device_ms(lambda: ca.mma_bwd(
        q, k, v, out, dout, lse, causal, 0), reps=reps, replays=3)
    r["bwd_plain_ms"] = device_ms(lambda: ref.chunked_attention_bwd(
        q, k, v, out, dout, lse, causal=causal), reps=max(2, reps // 5),
        replays=2)
    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    # SDPA's backward: autograd's backward of one SDPA forward (run once,
    # before), queued behind a device sleep.  Within this script the
    # profiler shows none of its bf16 kernels (cuDNN's), and a CUDA graph
    # cannot capture it at every shape
    o = F.scaled_dot_product_attention(*xs, is_causal=is_causal)
    r["bwd_library_ms"] = queued_ms(lambda: torch.autograd.grad(
        o, xs, dout, retain_graph=True))
    del o

    def loop_both():
        o = ref.chunked_attention(*xs, causal=causal)
        torch.autograd.grad(o, xs, dout)

    r["loop_fwd_bwd_ms"] = call_ms(loop_both, reps=5, warm=1)
    return r


def phase_attn() -> list:
    """The chunked-attention kernels (``repro_torch.kernels.
    chunked_attention``: the ``tile`` and ``split`` routes of
    ``csrc/chunked_attention_sm90.cu`` and ``_bwd_sm90.cu``, the ``mma``
    and ``simt`` routes of ``csrc/chunked_attention.cu``, forward and
    backward) against the plain loop on the card.  First the edge sweep through the entry (the
    planned routes): float32 and bf16, every d in :data:`ATTN_D`, causal
    and not, ``q_offset`` 0 and 37, every Tq in :data:`ATTN_TQ` against
    every Tk in :data:`ATTN_TK` (B = 2, H = 2), output and the gradients
    of q, k and v (:func:`_attn_check`, two runs bitwise equal).  Then
    each main path's shape in bf16 (:data:`ATTN_PATHS`): the planned
    route and the ``mma`` route on the same inputs, each checked the
    same way (the gradients on the training paths), and timed beside the
    plain loop, SDPA and the bound; then the split / tile threshold's
    sweep.  Returns the kernels line's records, one a route and way
    (``launches`` and ``main_path`` filled from the main paths'
    phases)."""
    from repro_torch.kernels import chunked_attention as ca
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(24)
    clock = _sm_clock_hz()
    saved = (_attn_counts(), _attn_routes())
    worst, n = {}, 0
    _reset_attn()
    for dtype in (torch.float32, torch.bfloat16):
        for d in ATTN_D:
            for causal, off in ATTN_MASKS:
                for tq in ATTN_TQ:
                    for tk in ATTN_TK:
                        args = _attn_inputs(2, 2, tq, tk, d, dtype, gen)
                        res = _attn_check(
                            f"attn {dtype} d={d} causal={causal} "
                            f"q_offset={off} Tq={tq} Tk={tk}", *args,
                            causal, off)
                        n += 1
                        for name, e in res.items():
                            key = (str(dtype).removeprefix("torch."), name)
                            share = e["err"] / max(e["allow"], 1e-30)
                            worst[key] = max(worst.get(key, 0.0), share)
        _free()
    swept = _attn_routes()
    print(f"[attn] edge sweep: {n} calls, each twice (float32 and bf16; d "
          f"{ATTN_D}; causal and not, q_offset 0 and 37; Tq {ATTN_TQ} x Tk "
          f"{ATTN_TK}), output and the gradients of q, k and v agree with "
          f"the plain loop and two runs are bitwise equal; routes forward "
          f"{swept[0]}, backward {swept[1]}; largest share of the allowance "
          f"(float32 {ATTN_F32_TOL} of max; bf16 the bf16 loop's own error "
          f"from the float32 loop plus one bf16 ulp): " + ", ".join(
              f"{t} {nm} {s:.3f}" for (t, nm), s in sorted(worst.items()))
          + f" ({time.perf_counter() - t0:.1f} s)")
    if not all(swept[0].values()) or not all(swept[1].values()):
        fail(f"attn: the sweep left a route unlaunched: {swept}")
    _attn_head_sweep(gen)
    paths = {}
    for path, (b, h, tq, tk, d, causal, bwd) in ATTN_PATHS.items():
        args = _attn_inputs(b, h, tq, tk, d, torch.bfloat16, gen)
        err = _attn_check(f"attn {path}", *args, causal, 0, grads=bwd)
        err_mma = _attn_held(f"attn {path} mma route",
                             _attn_mma(*args, causal, 0, grads=bwd), *args,
                             causal, 0, bwd)
        r = {"shape": [b, h, tq, tk, d], "causal": causal, "err": err,
             "err_mma": err_mma, **_attn_times(*args, causal, bwd)}
        r["fwd_bound"] = _attn_bound(b, h, tq, tk, d, causal, False,
                                     torch.bfloat16, clock)
        if bwd:
            r["bwd_bound"] = _attn_bound(b, h, tq, tk, d, causal, True,
                                         torch.bfloat16, clock)
        paths[path] = r
        for way in ("fwd", "bwd") if bwd else ("fwd",):
            bd = r[f"{way}_bound"]
            e = {k: v["err"] for k, v in err.items()}
            print(f"[attn] {path} ({b} x {h} x {tq} x {tk}, d={d}"
                  f"{', causal' if causal else ''}) {way}: route "
                  f"{r[f'{way}_route']} {r[f'{way}_ms'] * 1e3:.2f} us a "
                  f"launch; the mma route "
                  f"{r[f'{way}_mma_ms'] * 1e3:.2f} us "
                  f"({r[f'{way}_mma_ms'] / r[f'{way}_ms']:.2f}x); plain "
                  f"{r[f'{way}_plain_ms'] * 1e3:.2f} us; SDPA "
                  f"{r[f'{way}_library_ms'] * 1e3:.2f} us; bound "
                  f"{bd['bound_ms'] * 1e3:.2f} us by {bd['bound_kind']} ("
                  + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in
                              bd["bound_terms_ms"].items())
                  + f"), {bd['bound_ms'] / r[f'{way}_ms']:.1%} of it (mma "
                  f"{bd['bound_ms'] / r[f'{way}_mma_ms']:.1%}); max abs "
                  f"error against the float32 loop "
                  + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
                  + (f"; the loop forward and autograd backward "
                     f"{r['loop_fwd_bwd_ms'] * 1e3:.1f} us (eager)"
                     if way == "bwd" else "") + f" ({smi()})")
        del args
        _free()
    # where the split route stops beating the tile route
    for b, h, tk, d in ATTN_THRESHOLD_SHAPES:
        cells = []
        for tq in ATTN_THRESHOLD_TQ:
            q, k, v, _ = _attn_inputs(b, h, tq, tk, d, torch.bfloat16, gen)
            t_split = device_ms(lambda: ca.split_fwd(q, k, v, False),
                                reps=50, replays=3)
            t_tile = device_ms(lambda: ca.tile_fwd(q, k, v, False),
                               reps=50, replays=3)
            cells.append(f"Tq {tq}: split {t_split * 1e3:.2f} / tile "
                         f"{t_tile * 1e3:.2f}")
        print(f"[attn] threshold ({b} x {h} x Tq x {tk}, d={d}), us a "
              f"launch: " + "; ".join(cells) + f" (the plan takes split up "
              f"to Tq {ca.SPLIT_MAX_TQ})")
    # the float32 entries at [train-small]'s shape: the head route and
    # the simt route on the same inputs
    b, h, tq, tk, d, causal, _ = ATTN_SMOKE
    args = _attn_inputs(b, h, tq, tk, d, torch.float32, gen)
    err = _attn_check("attn smoke float32", *args, causal, 0)
    err_simt = _attn_held("attn smoke float32 simt route",
                          _attn_mma(*args, causal, 0), *args, causal, 0, True)
    small = {"shape": [b, h, tq, tk, d], "causal": causal, "err": err,
             "err_mma": err_simt, **_attn_times(*args, causal, True),
             "fwd_bound": _attn_bound(b, h, tq, tk, d, causal, False,
                                      torch.float32, clock),
             "bwd_bound": _attn_bound(b, h, tq, tk, d, causal, True,
                                      torch.float32, clock)}
    print(f"[attn] float32 at the smoke configs' shape ({b} x {h} x {tq} x "
          f"{tk}, d={d}, causal): routes {small['fwd_route']} / "
          f"{small['bwd_route']}, forward {small['fwd_ms'] * 1e3:.2f} us, "
          f"backward {small['bwd_ms'] * 1e3:.2f} us a launch; plain "
          f"{small['fwd_plain_ms'] * 1e3:.2f} / "
          f"{small['bwd_plain_ms'] * 1e3:.2f} us")
    # the head route beside the routes it replaced, on the same inputs, and
    # the launch floor: a one-element zero_ timed the same way
    z = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: z.zero_(), reps=50, replays=3)
    for name, r, old in (("smoke", small, "simt"),
                         ("jamba-smoke-train", paths["jamba-smoke-train"],
                          "mma")):
        r["floor_ms"] = floor_ms
        if (r["fwd_route"], r["bwd_route"]) != ("head", "head"):
            fail(f"attn: {name} took routes {r['fwd_route']} / "
                 f"{r['bwd_route']}, not head")
        for way in ("fwd", "bwd"):
            bd = r[f"{way}_bound"]
            print(f"[attn] head route at {name} {tuple(r['shape'])} {way}: "
                  f"{r[f'{way}_ms'] * 1e3:.3f} us a launch, {old} "
                  f"{r[f'{way}_mma_ms'] * 1e3:.3f} us "
                  f"({r[f'{way}_mma_ms'] / r[f'{way}_ms']:.2f}x); launch "
                  f"floor {floor_ms * 1e3:.3f} us (head "
                  f"{r[f'{way}_ms'] / floor_ms:.2f}x, {old} "
                  f"{r[f'{way}_mma_ms'] / floor_ms:.2f}x); plain "
                  f"{r[f'{way}_plain_ms'] * 1e3:.2f} us; SDPA "
                  f"{r[f'{way}_library_ms'] * 1e3:.2f} us; bound "
                  f"{bd['bound_ms'] * 1e3:.4f} us by {bd['bound_kind']} "
                  f"({smi()})")
    # the head route's limit: head against the route it replaced at T up
    # to HEAD_MAX_T, the smoke configs' 2 x 4 heads, causal
    for dtype, old in ((torch.float32, "simt"), (torch.bfloat16, "mma")):
        cells = []
        for t in ATTN_HEAD_LIMIT_T:
            q, k, v, dout = _attn_inputs(2, 4, t, t, 16, dtype, gen)
            out, lse = ca.head_fwd(q, k, v, True, 0)
            us = [device_ms(fn, reps=50, replays=3) * 1e3 for fn in (
                lambda: ca.head_fwd(q, k, v, True, 0),
                lambda: ca.mma_fwd(q, k, v, True, 0),
                lambda: ca.head_bwd(q, k, v, out, dout, lse, True, 0),
                lambda: ca.mma_bwd(q, k, v, out, dout, lse, True, 0))]
            cells.append(f"T {t}: forward {us[0]:.2f} / {us[1]:.2f}, "
                         f"backward {us[2]:.2f} / {us[3]:.2f}")
        print(f"[attn] head limit ({dtype}, 2 x 4 x T x T, d=16, causal), "
              f"us a launch head / {old}: " + "; ".join(cells)
              + f" (HEAD_MAX_T {ca.HEAD_MAX_T})")
    (ca.chunked_attention.launches,
     ca.chunked_attention.bwd_launches) = saved[0]
    ca.chunked_attention.route_launches.update(saved[1][0])
    ca.chunked_attention.bwd_route_launches.update(saved[1][1])
    print(f"[attn] SM clock {clock / 1e9:.3f} GHz (max, nvidia-smi) for the "
          f"exp bound; split workspace at the decode paths: " + ", ".join(
              f"{p} {ca.split_plan(*_split_rows(p))[0]} splits of "
              f"{ca.split_plan(*_split_rows(p))[1]} keys, "
              f"{_split_ws_bytes(p) / 1e6:.3f} MB" for p in
              ("whisper-cross-decode", "llama-cross-decode"))
          + f"; {time.perf_counter() - t0:.1f} s")
    shapes = dict(paths, smoke=small)

    def record(way, route):
        name, src, main, others = ATTN_RECORDS[(way, route)]
        r = shapes[main]
        bd = r[f"{way}_bound"]
        keys = ("out",) if way == "fwd" else ("dq", "dk", "dv")
        # a baseline route: chunked_attention.cu's, timed beside the
        # planned one
        base = route in ATTN_BASELINES
        if not base and r[f"{way}_route"] != route:
            fail(f"attn: {main} took the {r[f'{way}_route']} route, not "
                 f"{route}")
        ms = r[f"{way}_mma_ms" if base else f"{way}_ms"]
        err = r["err_mma" if base else "err"]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/chunked_attention"
                          f"{'_' + src if src else ''}.cu",
                "replaces": "src/repro/models/layers.py:110",
                "attn_route": route,
                "launches": None, "main_path": None,
                "max_abs_err": max(err[x]["err"] for x in keys),
                "err_against": "the plain loop in float32 on the same "
                               "values",
                "ms": ms, "plain_ms": r[f"{way}_plain_ms"],
                "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                "library_ms": r[f"{way}_library_ms"],
                "library": "torch.nn.functional.scaled_dot_product_attention"
                           + (" (autograd's backward of it, queued behind "
                              "a device sleep)" if way == "bwd" else ""),
                "mma_route_ms": r.get(f"{way}_mma_ms"),
                "launch_floor_ms": r.get("floor_ms"),
                "shape": r["shape"], "at": main,
                "bound_share": bd["bound_ms"] / ms,
                "attn": (way, route),
                "paths": {p: {k: v for k, v in paths[p].items()
                              if k.startswith(way) or k in ("shape",
                                                            "floor_ms")}
                          for p in others}}

    return [record(way, route) for way, route in ATTN_RECORDS]


def _attn_head_sweep(gen) -> None:
    """The head route's edges through the entry (:func:`_attn_check`):
    every Tq against every Tk of :data:`ATTN_HEAD_T`, d 16, B = 2, H = 2,
    float32 and bf16, each mask of :data:`ATTN_MASKS`; fails unless every
    launch, forward and backward, went by the head route."""
    t0 = time.perf_counter()
    before = _attn_routes()
    worst, n = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for causal, off in ATTN_MASKS:
            for tq in ATTN_HEAD_T:
                for tk in ATTN_HEAD_T:
                    args = _attn_inputs(2, 2, tq, tk, 16, dtype, gen)
                    res = _attn_check(
                        f"attn head {dtype} causal={causal} q_offset={off} "
                        f"Tq={tq} Tk={tk}", *args, causal, off)
                    n += 1
                    for name, e in res.items():
                        key = (str(dtype).removeprefix("torch."), name)
                        share = e["err"] / max(e["allow"], 1e-30)
                        worst[key] = max(worst.get(key, 0.0), share)
    moved = [{r: a[r] - b[r] for r in a}
             for a, b in zip(_attn_routes(), before)]
    if any(m != {r: 2 * n * (r == "head") for r in m} for m in moved):
        fail(f"attn head sweep: launches by route {moved}, want all "
             f"{2 * n} forward and backward by head")
    print(f"[attn] head route sweep: {n} calls, each twice (float32 and "
          f"bf16, d 16, Tq and Tk each in {ATTN_HEAD_T}, causal and not, "
          f"q_offset 0 and 37), every launch by head, output and gradients "
          f"agree with the plain loop, two runs bitwise equal; largest "
          f"share of the allowance: " + ", ".join(
              f"{t} {nm} {s:.3f}" for (t, nm), s in sorted(worst.items()))
          + f" ({time.perf_counter() - t0:.1f} s)")


def _split_rows(path):
    """(B*H, Tq, Tk) of an ATTN_PATHS shape, as split_plan takes them."""
    b, h, tq, tk = ATTN_PATHS[path][:4]
    return b * h, tq, tk


def _split_ws_bytes(path) -> int:
    """The split route's workspace at an ATTN_PATHS shape."""
    from repro_torch.kernels import chunked_attention as ca
    bh, tq, tk = _split_rows(path)
    return bh * tq * ca.split_plan(bh, tq, tk)[0] * (ATTN_PATHS[path][4] + 2) \
        * 4


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
    ("chunked attention", ATTN_KERNELS),
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


def phase_cross() -> dict:
    """Llama-3.2-Vision-90B at full width with one layer group (n_layers
    100 -> 5) and Whisper-medium whole (24 + 24 layers), through
    ``Model.prefill`` / ``decode_step`` (the engine passes no memory) with
    seeded stub memory: 1024 patches, 1500 frames.  The enc-dec decode
    steps cross-attend to the memory the port's ``_encode`` gives once, as
    the reference's decode takes memory as passed.  Every cross sublayer
    and encoder layer launches the chunked-attention kernel once a call
    (counted; the plain loop never reached on the card), prefill and the
    encoder by the tile route, each decode step's one query by the split
    route; the wave is served again with attention as its plain loop,
    which must commit the same tokens (or a bf16 argmax tie, reported
    with its logit gap).  Returns the timed wave's forward launches by
    route, by arch."""
    import dataclasses
    from repro_torch.configs import base as cbase
    from repro_torch.models.model import build_model
    dev = torch.device("cuda")
    launches = {}
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
        with _no_plain_attention():
            for run in ("warm-up", "timed"):
                timed = _TimedModel(model, keep_logits=run == "timed")
                _reset_attn()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                dec = model._encode(params, mem) \
                    if cfg.family == "encdec" else mem
                torch.cuda.synchronize()
                enc_ms = (time.perf_counter() - t1) * 1e3
                _, out = _greedy(timed, params, toks, SERVE["max_new"], mem,
                                 dec, pads)
        fwd, bwd = _attn_counts()
        # one launch a cross sublayer a call (prefill and each decode
        # step), and the encoder's layers once in _encode and once in the
        # prefill
        calls = SERVE["max_new"] + 1
        want = cfg.n_layers // cfg.cross_stride * calls \
            if cfg.family == "vlm" else \
            cfg.n_layers * calls + 2 * cfg.n_enc_layers
        if (fwd, bwd) != (want, 0):
            fail(f"cross {arch}: chunked attention launched {fwd} forward, "
                 f"{bwd} backward; want {want}, 0")
        # prefill (and the encoder) by the tile route, each decode step's
        # one query by the split route
        launches[arch] = routes = _attn_routes()[0]
        if set(r for r, n in routes.items() if n) != {"tile", "split"}:
            fail(f"cross {arch}: chunked attention routes {routes}, want "
                 f"tile and split")
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
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; chunked "
              f"attention launched {fwd} times (by route {routes}), no "
              f"plain loop reached ({smi()})")
        # the same wave with attention as its plain loop
        plain = _TimedModel(model, keep_logits=True)
        with _plain_attention():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pdec = model._encode(params, mem) if cfg.family == "encdec" \
                else mem
            torch.cuda.synchronize()
            penc_ms = (time.perf_counter() - t1) * 1e3
            _, pout = _greedy(plain, params, toks, SERVE["max_new"], mem,
                              pdec, pads)
        if _attn_counts() != (fwd, 0):
            fail(f"cross {arch}: the plain wave launched a kernel")
        same = _same_tokens(f"cross {arch}",
                            {i: out[i].tolist() for i in range(len(out))},
                            {i: pout[i].tolist() for i in range(len(pout))},
                            timed, plain)
        penc = (f", encoder alone {penc_ms:.2f} ms"
                if cfg.family == "encdec" else "")
        print(f"[cross] {cfg.name}: {_tokens_line(same)}; with attention as "
              f"its plain loop: prefill {plain.prefill_s[0] * 1e3:.2f} ms, "
              f"decode {float(np.mean(plain.decode_s)) * 1e3:.3f} ms a "
              f"step{penc}")
        del pdec, pout, plain
        with _no_plain_attention():
            _print_profile("cross", _serve_profile(lambda: _greedy(
                _TimedModel(model), params, toks, SERVE["max_new"], mem,
                dec, pads)))
        del params, mem, dec, model
    _free()
    _reset_attn()
    return launches


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
    ("attention", ATTN_KERNELS),
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
    forward and backward, once a layer a pass, every one (float32, T = 16)
    by the chunked routes (RWKV-6 ``chunked``, Mamba ``chunk``), forward
    and backward.  Then a gradient through ``dispatch="spec-kernel"`` and
    through each of the five Pallas sites' entries must raise on CUDA
    tensors, as ``jax.grad`` through the reference's Pallas kernels does.
    Returns the scans' launches, backward and forward, and the
    chunked-attention launches (forward, backward): on the card one where
    the CPU run called the plain loop."""
    from repro_torch.configs import base as cbase
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import make_train_step, value_and_grad
    worst = 0.0
    scan_bwd, scan_fwd = {}, {}
    attn = (0, 0)
    attn_routes = ({}, {})  # launches by route, forward and backward
    for arch in cbase.ASSIGNED:
        cfg = cbase.smoke(cbase.get(arch))
        init, step_fn, name = make_train_step(
            build_model(cfg, "spec"), peak_lr=1e-3, warmup=1, total=10)
        state0 = init(torch.Generator().manual_seed(7), "cpu")
        data = SyntheticLM(DataConfig(vocab=cfg.vocab,
                                      seq_len=TRAIN_SMALL["seq_len"],
                                      global_batch=TRAIN_SMALL["batch"]))
        mem = _stub_memory(cfg, TRAIN_SMALL["batch"],
                           torch.Generator().manual_seed(8), "cpu",
                           torch.float32)
        runs = {}
        for dev in ("cpu", "cuda"):
            _reset_scans()
            _reset_attn()
            state, losses = _to(state0, dev, clone=True), []
            with _no_plain_attention() as plain:
                for i in range(3):
                    state, m = step_fn(state, _train_batch(cfg, data, i, dev,
                                                           mem))
                    losses.append(float(m["loss"]))
            runs[dev] = (losses, [t.cpu() for t in _flat(state.params)],
                         int(state.step))
            if dev == "cpu":
                loop_calls = plain["cpu"]
        # on the card the kernel launches where the CPU ran the loop, and
        # its backward once for every two forwards (the checkpoint's
        # recompute)
        fwd, bwd = _attn_counts()
        if fwd != loop_calls or 2 * bwd != fwd:
            fail(f"train-small {arch}: chunked attention launched {fwd} "
                 f"forward, {bwd} backward; the CPU run called the loop "
                 f"{loop_calls} times")
        # every float32 attention of a smoke config (d 16, at most 24
        # queries and keys) by the head route, forward and backward
        routes = _attn_routes()
        if routes != ({**dict.fromkeys(routes[0], 0), "head": fwd},
                      {**dict.fromkeys(routes[1], 0), "head": bwd}):
            fail(f"train-small {arch}: chunked attention launched by route "
                 f"{routes}, want every launch by head")
        attn = (attn[0] + fwd, attn[1] + bwd)
        for total, counts in zip(attn_routes, routes):
            for r, c in counts.items():
                total[r] = total.get(r, 0) + c
        # on the card each scan layer runs forward twice a step (the
        # group's checkpoint recomputes it) and backward once, all by the
        # chunked routes (float32, T = 16)
        want = {n: (2 * 3 * k, 3 * k) for n, k in (
            ("rwkv6_scan", _n_sublayers(state0.params, "rwkv")),
            ("mamba_scan", _n_sublayers(state0.params, "mamba"))) if k}
        chunked = {"rwkv6_scan": "chunked", "mamba_scan": "chunk"}
        _check_scans(f"train-small {arch}", want,
                     {n: {chunked[n]: f} for n, (f, _) in want.items()},
                     {n: {chunked[n]: b} for n, (_, b) in want.items()})
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
                        for n, (f, b) in want.items())
              + (f"; chunked attention launched {fwd} forward, {bwd} "
                 f"backward" if fwd else ""))
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
    _reset_attn()
    torch.cuda.synchronize()
    print(f"[train-small] all {len(cbase.ASSIGNED)} configs agree card "
          f"against CPU (parameters within {worst:.3g}, atol {SMOKE_TOL}); "
          f"on CUDA tensors a gradient through dispatch=spec-kernel and "
          f"through each of the {len(calls)} kernel entries raises "
          f"NotImplementedError; the scans' backward kernels launched "
          f"{scan_bwd}, their forward ones {scan_fwd} (float32, T = 16: all "
          f"by the chunked / chunk routes, forward and backward); chunked "
          f"attention "
          f"launched {attn[0]} forward, {attn[1]} backward (float32), all "
          f"by the head route, no plain loop reached on the card")
    if not all(attn):
        fail(f"train-small: chunked attention launched {attn}")
    return {"bwd": scan_bwd, "fwd": scan_fwd, "attn": attn,
            "attn_routes": attn_routes}


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
    _reset_attn()
    losses, times = [], []
    with _no_plain_attention():
        for i in range(1 + TRAIN["timed"]):
            batch = _train_batch(cfg, data, i, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))  # waits for the step
            times.append(time.perf_counter() - t1)
    _no_kernel_launched(tag)
    scans = (_scan_launches(), _scan_routes(), _scan_bwd_routes())
    attn = _attn_counts()
    # the group checkpoint runs each attention forward twice a step
    n_attn = _n_sublayers(state.params, "attn") * len(losses)
    if attn != (2 * n_attn, n_attn):
        fail(f"{tag}: chunked attention launched {attn} (forward, "
             f"backward); want {(2 * n_attn, n_attn)}")
    attn_routes = _attn_routes()
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
          + (" but the scans" if any(map(any, scans[0].values())) else "")
          + (f" and chunked attention ({attn[0]} forward, {attn[1]} backward"
             f" launches; no plain loop reached)" if any(attn) else ""))
    batch = _train_batch(cfg, data, len(losses), dev)
    with _no_plain_attention():
        prof = _train_profile(lambda: step_fn(state, batch))
    if any(attn):
        att = sum(v for k, v in prof["by_name"].items()
                  if any(f in k for f in ATTN_KERNELS))
        print(f"[{tag}] chunked attention in the profiled step: {att:.3f} ms "
              f"of device time")
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
            "steps": len(losses), "attn": attn_routes,
            "n_attn": _n_sublayers(state.params, "attn"),
            "n_mamba": _n_sublayers(state.params, "mamba")}


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


def phase_train_dense() -> tuple:
    """Phi-4-mini-3.8B whole (32 layers, nothing cut), bf16, AdamW.
    Returns the chunked-attention launches by route (forward,
    backward)."""
    from repro_torch.configs import base as cbase
    cfg = cbase.get("phi4_mini_3_8b")
    res = _train_full("train-dense", cfg, f"all {cfg.n_layers} layers, "
                      f"nothing cut", "adamw")
    _free()
    return res["attn"]


def phase_train_moe() -> tuple:
    """Grok-1-314B at full width, one [attn, moe] group (n_layers 64 ->
    1), ``dispatch="spec"``, Adafactor as ``make_optimizer`` picks for the
    whole model.  Returns the chunked-attention launches by route
    (forward, backward)."""
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
    res = _train_full("train-moe", cfg, f"n_layers {full.n_layers} cut "
                      f"to 1, one [attn, moe] group, {cfg.n_experts} "
                      f"experts top-{cfg.top_k}", "adafactor", opt_cfg=full)
    _free()
    return res["attn"]


#: [train-kimi]'s cut of Kimi-K2 (61 layers, 384 experts): one [attn, moe]
#: group with 128 experts (top-8 and the shared expert kept), 32.6 GB of
#: bf16 weights and gradients beside Adafactor's float32 copies of the
#: 1.88e9-element expert leaf (7.5 GB each); with all 384 the weights and
#: gradients alone are 77.7 GB
TRAIN_KIMI = dict(n_layers=1, n_experts=128)
#: [train-jamba]'s cut of Jamba-1.5-Large (72 layers, 16 experts): one
#: group of 8 layers (7 Mamba, 1 attention, 4 MoE, 4 MLP) with 4 experts
#: (top-2 kept; 2 would route every token to both), 14.7e9 parameters,
#: 59 GB of bf16 weights and gradients; 2 sequences of 1024 tokens a step,
#: as TRAIN_SSM (SSMs train at long contexts)
TRAIN_JAMBA = dict(n_layers=8, n_experts=4, batch=2, seq_len=1024)


def train_cut(arch: str, cut: dict):
    """The published config of ``arch`` and its cut for one card:
    ``cut``'s ``n_layers`` and ``n_experts`` replaced, every other field
    the published one (``batch`` and ``seq_len`` are the step's, not the
    config's)."""
    import dataclasses
    from repro_torch.configs import base as cbase
    full = cbase.get(arch)
    return full, dataclasses.replace(full, n_layers=cut["n_layers"],
                                     n_experts=cut["n_experts"])


def _check_attn_tile(tag, res, cfg, d) -> str:
    """Fails unless ``cfg``'s head width is ``d`` and every
    chunked-attention launch of ``_train_full``'s result ``res`` was by
    the tile route (forward twice a layer a step with the checkpoint's
    recompute, backward once).  Returns the counts as words."""
    if cfg.hd != d:
        fail(f"{tag}: head width {cfg.hd}, want {d}")
    fwd, bwd = res["attn"]
    n = res["n_attn"] * res["steps"]
    if fwd != {**dict.fromkeys(fwd, 0), "tile": 2 * n} or \
            bwd != {**dict.fromkeys(bwd, 0), "tile": n}:
        fail(f"{tag}: chunked attention by route forward {fwd}, backward "
             f"{bwd}; want every launch tile ({2 * n} forward, {n} "
             f"backward)")
    return (f"{2 * n} forward and {n} backward launches over the "
            f"{res['steps']} steps, all tile at d {d}")


def _attn_split(res) -> dict:
    parts = res["profile"]["parts"]
    return {p: parts[p].get("attention", 0.0) for p in ("forward",
                                                       "backward")}


def phase_train_kimi() -> tuple:
    """Kimi-K2 at its published width (d_model 7168, 64 heads of 112, 8
    KV heads, expert d_ff 2048, top-8, one shared expert, vocab 163840,
    bf16) cut by :data:`TRAIN_KIMI`, Adafactor as
    ``make_optimizer(get("kimi_k2_1t_a32b"))`` picks for the whole model,
    ``dispatch="spec"``, ``TRAIN``'s 8 x 256 tokens a step through
    :func:`_train_full`: every chunked-attention launch on the tile route
    at d 112 (the width's only training path) and the plain loop never
    reached.  Prints the profiled step's attention device ms in the
    forward and backward ranges.  Returns the chunked-attention launches
    by route (forward, backward) and the step's numbers."""
    import dataclasses
    from repro_torch.configs import base as cbase
    full, cfg = train_cut("kimi_k2_1t_a32b", TRAIN_KIMI)
    group = cbase.param_count(dataclasses.replace(
        cfg, n_experts=full.n_experts))[0]
    cut = (f"n_layers {full.n_layers} cut to {cfg.n_layers}, one [attn, "
           f"moe] group, experts {full.n_experts} cut to {cfg.n_experts} "
           f"top-{cfg.top_k} with {cfg.n_shared_experts} shared "
           f"({cbase.param_count(cfg)[0] / 1e9:.2f}e9 parameters kept; a "
           f"group with all {full.n_experts} holds {group / 1e9:.2f}e9, "
           f"{4 * group / 1e9:.1f} GB of bf16 weights and gradients); "
           f"{TRAIN['batch']} x {TRAIN['seq_len']} tokens a step, not cut")
    print(f"[train-kimi] optimizer from make_optimizer(get("
          f"'kimi_k2_1t_a32b')): {cbase.param_count(full)[0] / 1e9:.1f}e9 "
          f"parameters pick adafactor; {cut}")
    res = _train_full("train-kimi", cfg, cut, "adafactor", opt_cfg=full)
    words = _check_attn_tile("train-kimi", res, cfg, 112)
    att = _attn_split(res)
    print(f"[train-kimi] chunked attention: {words}; in the profiled step "
          f"forward range {att['forward']:.3f} ms ({cfg.n_layers} forward "
          f"launches), backward range {att['backward']:.3f} ms "
          f"({cfg.n_layers} forward launches of the checkpoint's recompute, "
          f"{cfg.n_layers} backward) ({smi()})")
    _free()
    return res["attn"], _train_numbers(res)


def _train_numbers(res) -> dict:
    """The numbers of a ``_train_full`` result the result line keeps."""
    prof = res["profile"]
    return {k: res[k] for k in ("step_ms", "tokens_s", "losses",
                                "peak_bytes", "flop_ms", "opt_ms")} | {
        "window_ms": prof["window_ms"], "busy_ms": prof["busy_ms"],
        "idle_share": prof["idle_share"],
        "parts_ms": {p: sum(k.values()) for p, k in prof["parts"].items()}}


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
    n_attn = _n_sublayers(state.params, "attn")
    _reset_scans()
    _reset_attn()
    losses = []
    with _no_plain_scans(), _no_plain_attention():
        for i in range(3):
            state, m = step_fn(state, _train_batch(scfg, data, i, "cuda"))
            losses.append(float(m["loss"]))
    out_attn = _attn_counts()
    if out_attn != (2 * 3 * n_attn, 3 * n_attn):
        fail(f"train-ssm jamba smoke: chunked attention launched {out_attn}"
             f", want {(2 * 3 * n_attn, 3 * n_attn)}")
    # d 16 with 64 queries and keys: every launch by the head route
    routes = _attn_routes()
    if routes != ({**dict.fromkeys(routes[0], 0), "head": out_attn[0]},
                  {**dict.fromkeys(routes[1], 0), "head": out_attn[1]}):
        fail(f"train-ssm jamba smoke: chunked attention launched by route "
             f"{routes}, want every launch by head")
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
          f"{3 * n_mamba} backward by the chunk route; chunked attention "
          f"(bf16, d=16) {out_attn[0]} forward, {out_attn[1]} backward, "
          f"all by the head route")
    out["mamba_scan"] = dict(_scan_bwd_routes()["mamba_scan"])
    out["attn"] = _attn_routes()
    _reset_scans()
    _reset_attn()
    del state, model
    _free()
    return out


def phase_train_jamba() -> tuple:
    """Jamba-1.5-Large at its published width (d_model 8192, 64 heads of
    128, 8 KV heads, d_ff 24576, top-2, Mamba d_state 16, vocab 65536,
    bf16) cut by :data:`TRAIN_JAMBA`, Adafactor as
    ``make_optimizer(get("jamba_1_5_large_398b"))`` picks for the whole
    model, ``dispatch="spec"``, through :func:`_train_full`: every Mamba
    forward by the chunk route (twice a layer a step, with the
    checkpoint's recompute) and every backward by the chunk route (once),
    the step pair never, every chunked-attention launch on the tile route
    at d 128, and no plain loop reached.  Prints the profiled step's scan
    backward and forward device ms and its attention's.  Returns the
    Mamba backward launches by route, the chunked-attention launches by
    route (forward, backward) and the step's numbers."""
    import dataclasses
    from repro_torch.configs import base as cbase
    full, cfg = train_cut("jamba_1_5_large_398b", TRAIN_JAMBA)
    b, t = TRAIN_JAMBA["batch"], TRAIN_JAMBA["seq_len"]
    group = cbase.param_count(dataclasses.replace(
        cfg, n_experts=full.n_experts))[0]
    cut = (f"n_layers {full.n_layers} cut to {cfg.n_layers}, one group (7 "
           f"Mamba, 1 attention; 4 MoE, 4 MLP), experts {full.n_experts} "
           f"cut to {cfg.n_experts} top-{cfg.top_k} "
           f"({cbase.param_count(cfg)[0] / 1e9:.2f}e9 parameters kept; a "
           f"group with all {full.n_experts} holds {group / 1e9:.2f}e9, "
           f"{4 * group / 1e9:.1f} GB of bf16 weights and gradients); "
           f"{b} x {t} tokens a step, not cut")
    print(f"[train-jamba] optimizer from make_optimizer(get("
          f"'jamba_1_5_large_398b')): {cbase.param_count(full)[0] / 1e9:.1f}"
          f"e9 parameters pick adafactor; {cut}")
    with _no_plain_scans():
        res = _train_full("train-jamba", cfg, cut, "adafactor", opt_cfg=full,
                          batch=b, seq_len=t)
    words = _check_attn_tile("train-jamba", res, cfg, 128)
    (launches, fwd, bwd), steps = res["scans"], res["steps"]
    n = res["n_mamba"]
    want = {"rwkv6_scan": (0, 0), "mamba_scan": (2 * n * steps, n * steps)}
    if launches != want or \
            fwd["mamba_scan"] != {**dict.fromkeys(fwd["mamba_scan"], 0),
                                  "chunk": 2 * n * steps} or \
            bwd["mamba_scan"] != {**dict.fromkeys(bwd["mamba_scan"], 0),
                                  "chunk": n * steps}:
        fail(f"train-jamba: scan launches {launches}, forward by route {fwd}, "
             f"backward by route {bwd}; want {want}, every forward and "
             f"backward by the chunk route and the step pair never")
    by_name = res["profile"]["by_name"]
    bwd_ms = _scan_bwd_ms(by_name, SCAN_BWD_KERNELS)
    fwd_ms = _scan_bwd_ms(by_name, ("mamba_chunk_kernel",))
    att = _attn_split(res)
    print(f"[train-jamba] the Mamba scans (D {cfg.d_model}, N "
          f"{cfg.ssm_d_state}) in the profiled step: backward {bwd_ms:.3f} ms "
          f"of device time by the chunk route ({n} launches), forward "
          f"{fwd_ms:.3f} ms (chunk route, {2 * n} launches with the "
          f"checkpoint's recompute); over the {steps} steps the forward "
          f"launched {fwd['mamba_scan']} by route and the backward "
          f"{bwd['mamba_scan']}; chunked attention: {words}, forward range "
          f"{att['forward']:.3f} ms, backward range {att['backward']:.3f} "
          f"ms; no plain loop reached ({smi()})")
    _free()
    return (dict(bwd["mamba_scan"]), res["attn"],
            _train_numbers(res) | {"scan_bwd_ms": bwd_ms,
                                   "scan_fwd_ms": fwd_ms})


#: [train-stablelm]'s cut: StableLM-12B's layers kept (of 40)
TRAIN_STABLELM = dict(n_layers=8)


def phase_train_stablelm() -> tuple:
    """StableLM-12B at its published width (d_model 5120, 32 heads of 160,
    8 KV heads, d_ff 13824, vocab 100352, bf16), n_layers 40 cut to 8,
    AdamW as ``make_optimizer(get("stablelm_12b"))`` picks for the whole
    model, ``TRAIN``'s 8 x 256 tokens and timed steps through
    :func:`_train_full`: every chunked-attention launch, forward (twice a
    layer a step, with the group checkpoint's recompute) and backward
    (once), on the tile route at d 160, and the plain loop never reached.
    Prints the profiled step's attention device ms in the forward and
    backward ranges.  Returns the chunked-attention launches by route
    (forward, backward)."""
    import dataclasses
    from repro_torch.configs import base as cbase
    full = cbase.get("stablelm_12b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_STABLELM["n_layers"])
    cut = (f"n_layers {full.n_layers} cut to {cfg.n_layers} "
           f"({cbase.param_count(full)[0] / 1e9:.2f}e9 parameters whole "
           f"need ~{12 * cbase.param_count(full)[0] / 1e9:.0f} GB of bf16 "
           f"weights and gradients and float32 AdamW moments; "
           f"{cbase.param_count(cfg)[0] / 1e9:.2f}e9 kept)")
    print(f"[train-stablelm] optimizer from make_optimizer(get("
          f"'stablelm_12b')): {cbase.param_count(full)[0] / 1e9:.2f}e9 "
          f"parameters pick adamw; {cut}")
    res = _train_full("train-stablelm", cfg, cut, "adamw", opt_cfg=full)
    words = _check_attn_tile("train-stablelm", res, cfg, 160)
    att = _attn_split(res)
    print(f"[train-stablelm] chunked attention: {words}; in the profiled "
          f"step forward range {att['forward']:.3f} ms ({cfg.n_layers} "
          f"forward launches), backward range {att['backward']:.3f} ms "
          f"({cfg.n_layers} forward launches of the checkpoint's recompute, "
          f"{cfg.n_layers} backward); step {res['step_ms']:.1f} ms against "
          f"a {res['flop_ms']:.2f} ms FLOP bound "
          f"({res['flop_ms'] / res['step_ms']:.1%}) ({smi()})")
    _free()
    return res["attn"]


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


def _timed(name: str, fn, *args):
    """``fn(*args)``, printing its seconds."""
    t = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t:.1f} s", flush=True)
    return out


def main() -> None:
    """Run every phase; print the result lines only if all passed."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    t0 = time.perf_counter()
    _timed("build", phase_build)
    _timed("kernels", phase_kernels)
    _timed("parity", phase_parity)
    _timed("sim", phase_sim)
    line = _timed("full, epoch, line",
                  lambda: phase_line(*phase_full()))
    _timed("kernels-dense", phase_kernels_dense)
    line["kernels"] += _timed("api", phase_api_full)
    scans = _timed("scan", phase_scan)
    line["kernels"] += scans
    attn = _timed("attn", phase_attn)
    line["kernels"] += attn
    line["kernels"] += _timed("serve, mesh", phase_serve_full)
    grok = _timed("mesh-shards grok", phase_mesh_shards_grok)
    for rec in line["kernels"]:
        if "mesh" in rec:  # the two bf16 entries
            rec["mesh"]["shards"]["tp2_grok"] = grok[
                rec["name"].removesuffix("_bf16")]
    line["mesh_attn"] = _timed("mesh-attn", phase_mesh_attn)
    line["dryrun"] = _timed("dryrun", phase_dryrun)
    ssm = _timed("ssm", phase_ssm)
    hybrid = _timed("hybrid", phase_hybrid)
    for rec in line["kernels"]:
        if rec["name"] in hybrid:
            rec["jamba"] = hybrid[rec["name"]]
    cross = _timed("cross", phase_cross)
    train = _timed("train-small", phase_train_small)
    dense = _timed("train-dense", phase_train_dense)
    moe = _timed("train-moe", phase_train_moe)
    kimi, kimi_train = _timed("train-kimi", phase_train_kimi)
    ssm_train = _timed("train-ssm", phase_train_ssm)
    jamba_bwd, jamba_attn, jamba_train = _timed("train-jamba",
                                                phase_train_jamba)
    stablelm = _timed("train-stablelm", phase_train_stablelm)
    line["train_full_width"] = {"train-kimi": kimi_train,
                                "train-jamba": jamba_train}
    # the scans' launches by route on their main paths: the bf16 forward
    # routes in one served wave ([ssm], [hybrid]); the float32 chunked
    # routes, forward and backward, in [train-small]; the bf16 chunked
    # backward routes in [train-ssm] (RWKV-6-7B at full width; Jamba's
    # smoke config in bf16) and [train-jamba] (Mamba at D 8192).  A step
    # route no main path takes (Mamba's at T >= 2, both backward step
    # pairs, the float32 forward step routes: the timing baseline, and the
    # route of T = 1 and of tensors the chunked routes cannot take) is
    # listed apart, under "scan_baselines"
    small = "[train-small] smoke configs (float32), 3 steps"
    served = {"rwkv6_scan": (ssm, "[ssm] RWKV-6-7B wave"),
              "mamba_scan": (hybrid["mamba_scan"], "[hybrid] Jamba wave")}
    trained = {"rwkv6_scan": f"[train-ssm] RWKV-6-7B, {TRAIN_SSM['n_layers']} "
                             f"layers at full width, bf16",
               "mamba_scan": "[train-ssm] Jamba smoke config, bf16, 3 steps"}
    jamba_path = (f"[train-jamba] Jamba one group at full width, "
                  f"{TRAIN_JAMBA['n_experts']} experts, bf16")
    kimi_path = (f"[train-kimi] Kimi-K2 one group at full width, "
                 f"{TRAIN_KIMI['n_experts']} experts")
    baselines = []
    for rec in scans:
        name, route = rec["scan"], rec["scan_route"]
        wave, where = served[name]
        if route == "step_t2" or (route.endswith("step") and (
                route == "bwd_step" or rec["dtype"] == "float32"
                or not wave["routes"].get(route))):
            rec["launches"], rec["main_path"] = 0, None
            rec["baseline"] = (
                "the step-serial route, timed beside the chunked route on "
                "the same inputs; no main path takes it (float32 prefill "
                "and training, and bf16 prefill and training, go by the "
                "chunked routes; T = 1 and tensors the chunked routes "
                "cannot take still go by it)")
            baselines.append(rec)
            continue
        if rec["dtype"] == "float32":
            rec["launches"] = train["bwd" if route.startswith("bwd_")
                                   else "fwd"][name]
            rec["main_path"] = small
        elif route.startswith("bwd_"):
            rec["launches"] = ssm_train[name][route.removeprefix("bwd_")]
            rec["main_path"] = trained[name]
            if name == "rwkv6_scan":
                rec["train_ssm"] = ssm_train["train"]
            else:  # Jamba's one group at full width, beside its smoke run
                paths = {jamba_path: jamba_bwd[route.removeprefix("bwd_")],
                         trained[name]: rec["launches"]}
                rec["main_path"] = jamba_path
                rec["launches"] = sum(paths.values())
                rec["launches_by_path"] = paths
                rec["train_jamba"] = jamba_train
        else:
            rec["launches"], rec["main_path"] = wave["routes"][route], where
            rec["tokens_vs_plain"] = wave["tokens"]
        if not rec["launches"]:
            fail(f"{rec['name']}: no launch on its main path")
    line["kernels"] = [r for r in line["kernels"]
                       if not any(r is x for x in baselines)]
    line["scan_baselines"] = baselines
    # chunked attention's launches by route and path: bf16 in [cross]
    # (prefill by tile, decode by split) and the full-width training
    # phases (tile, d 112, 128 and 160), Jamba's bf16 smoke run in
    # [train-ssm] and float32 in [train-small] (d 16: head).  The routes
    # no main path takes now (mma, simt: ATTN_BASELINES) are listed apart,
    # under "attn_baselines", timed beside head on its main paths' inputs
    whisper = "[cross] Whisper-medium wave (encoder, cross)"
    llama = "[cross] Llama-3.2-Vision wave (cross)"
    jamba = "[train-ssm] Jamba smoke config, bf16"
    by_path = {
        ("fwd", "tile"): {
            whisper: cross["whisper_medium"]["tile"],
            llama: cross["llama_3_2_vision_90b"]["tile"],
            "[train-dense] Phi-4-mini": dense[0]["tile"],
            "[train-moe] Grok-1 group": moe[0]["tile"],
            kimi_path: kimi[0]["tile"], jamba_path: jamba_attn[0]["tile"],
            "[train-stablelm] StableLM-12B, 8 layers": stablelm[0]["tile"]},
        ("fwd", "split"): {
            whisper: cross["whisper_medium"]["split"],
            llama: cross["llama_3_2_vision_90b"]["split"]},
        ("fwd", "head"): {small: train["attn_routes"][0]["head"],
                          jamba: ssm_train["attn"][0]["head"]},
        ("fwd", "mma"): {jamba: ssm_train["attn"][0]["mma"]},
        ("fwd", "simt"): {small: train["attn_routes"][0]["simt"]},
        ("bwd", "tile"): {
            "[train-dense] Phi-4-mini": dense[1]["tile"],
            "[train-moe] Grok-1 group": moe[1]["tile"],
            kimi_path: kimi[1]["tile"], jamba_path: jamba_attn[1]["tile"],
            "[train-stablelm] StableLM-12B, 8 layers": stablelm[1]["tile"]},
        ("bwd", "head"): {small: train["attn_routes"][1]["head"],
                          jamba: ssm_train["attn"][1]["head"]},
        ("bwd", "mma"): {jamba: ssm_train["attn"][1]["mma"]},
        ("bwd", "simt"): {small: train["attn_routes"][1]["simt"]},
    }
    attn_baselines = []
    for rec in attn:
        paths = by_path[rec.pop("attn")]
        rec["main_path"] = next(iter(paths))
        rec["launches"] = sum(paths.values())
        rec["launches_by_path"] = paths
        if rec["attn_route"] in ATTN_BASELINES:
            if rec["launches"]:
                fail(f"{rec['name']}: launched on a main path: {paths}")
            rec["main_path"] = None
            rec["baseline"] = (
                "chunked_attention.cu's route, timed beside the head route "
                "on the same inputs; no main path takes it (the smoke "
                "configs' float32 attention and Jamba's bf16 smoke config go "
                "by head; float32 past d 16 or 64 queries or keys, and bf16 "
                "at d 16 past 64 or unaligned, still go by it)")
            attn_baselines.append(rec)
        elif not all(paths.values()):
            fail(f"{rec['name']}: no launch on a main path: {paths}")
    line["kernels"] = [r for r in line["kernels"]
                       if not any(r is x for x in attn_baselines)]
    line["attn_baselines"] = attn_baselines
    phase_train_ckpt()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(line))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
