"""Time the SSM step forwards at T >= 2 against alternatives of their
shape, in bf16 and in float32, and count their SASS instructions a state
element a step.

The step forwards (``rwkv6_step_fwd_kernel`` in ``csrc/rwkv6_scan.cu``,
``mamba_fwd_kernel`` in ``csrc/mamba_scan.cu``) keep the loop's roundings,
so their instruction count has a floor, and what is left to choose is how
the steps are staged and scheduled: tokens a run (the barrier's period,
the registers the next run's prefetch takes) and steps an iteration (how
far one step's read-out can overlap the next one's).  This script builds
the alternatives (:data:`VARIANTS`: each a few replacements of a copy of
the shipped source, each of which must match once), checks that each
gives the shipped state and y bit for bit (the same arithmetic in the
same order), counts each one's SASS instructions a state element a step
in its hot loop (:func:`per_element_step`), and times each at one
layer's width (RWKV-6-7B's 64 heads of 64, Jamba's 8192 Mamba channels),
B = 8, T = 512, by CUDA-graph replay of back-to-back calls of the C
entry, the variants alternating round by round.

Run on one H100 (it needs ``nvcc`` and ``cuobjdump``; it writes under
``build/``):

    PYTHONPATH=src python -m repro_torch.launch.step_fwd_variants [--rounds 3]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import statistics
import subprocess

from repro_torch.kernels import build
from repro_torch.launch import variants

#: B, T and width of the timed calls (RWKV-6: heads of :data:`HD`)
B, T = 8, 512
WIDTH = {"rwkv6_scan": 4096, "mamba_scan": 8192}
HD, N = 64, 16
#: each step forward's hot loop in SASS: the kernel's name fragment, the
#: instruction that marks one step of the loop and how many a step has,
#: and the state elements a thread holds (hd 64, N = 16)
KERNELS = {
    "rwkv6_scan": ("rwkv6_step_fwd_kernel", "SHFL.BFLY", 4, 32),
    "mamba_scan": ("mamba_fwd_kernel", "MUFU.EX2", 16, 16),
}
_R_LOOP = "#pragma unroll 2\n      for (int t = 0; t < kRun; ++t) token(buf, t);"
_R_RUN = "constexpr int kRun = 8;"
_R_UU = "  float uu[TR];\n  lds_vec<TR>(uu, &sm.u[row_at<HD>(i0)]);\n"
_R_TOK = "    float rr[TR], kk[TR], ww[TR], vv[TC];\n"
_M_LOOP = ("#pragma unroll 2\n"
           "      for (int i = 0; i < kStepRun; ++i) step(buf, i);")
_M_RUN = "constexpr int kStepRun = 16;"
_M_BODY = """#pragma unroll
    for (int n = 0; n < N; n += 2) {
      const float e0 = expf(__fmul_rn(dt, an[n]));
      const float e1 = expf(__fmul_rn(dt, an[n + 1]));
      s[n] = __fadd_rn(__fmul_rn(e0, s[n]), __fmul_rn(x, bv[n]));
      s[n + 1] = __fadd_rn(__fmul_rn(e1, s[n + 1]), __fmul_rn(x, bv[n + 1]));
      float r0 = s[n], r1 = s[n + 1];
      rnd2<T>(r0, r1);
      acc = fmaf(r0, cv[n], acc);
      acc = fmaf(r1, cv[n + 1], acc);
    }
"""
#: the Mamba step's exponentials, updates and read-out as three passes
_M_PHASES = """    float ee[N];
#pragma unroll
    for (int n = 0; n < N; ++n) ee[n] = expf(__fmul_rn(dt, an[n]));
#pragma unroll
    for (int n = 0; n < N; ++n)
      s[n] = __fadd_rn(__fmul_rn(ee[n], s[n]), __fmul_rn(x, bv[n]));
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      float r0 = s[n], r1 = s[n + 1];
      rnd2<T>(r0, r1);
      acc = fmaf(r0, cv[n], acc);
      acc = fmaf(r1, cv[n + 1], acc);
    }
"""
#: each library's variants: name -> replacements of the shipped source
#: (the first is the shipped source)
VARIANTS = {
    "rwkv6_scan": {
        "runs of 8, two tokens an iteration": [],
        "one token an iteration": [(_R_LOOP, _R_LOOP.replace("unroll 2",
                                                             "unroll 1"))],
        "runs of 4": [(_R_RUN, "constexpr int kRun = 4;")],
        "u read each token": [(_R_UU, ""), (_R_TOK, _R_TOK + _R_UU.replace(
            "  ", "    ", 2))],
    },
    "mamba_scan": {
        "runs of 16, two steps an iteration": [],
        "one step an iteration": [(_M_LOOP, _M_LOOP.replace("unroll 2",
                                                           "unroll 1"))],
        "four steps an iteration": [(_M_LOOP, _M_LOOP.replace("unroll 2",
                                                             "unroll 4"))],
        "runs of 8": [(_M_RUN, "constexpr int kStepRun = 8;")],
        "three passes a step": [(_M_BODY, _M_PHASES)],
    },
}


def sass_functions(path) -> dict:
    """A built library's SASS by function (mangled name -> its lines), or
    {} without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        head, _, body = block.partition("\n")
        out[head.strip()] = body.splitlines()
    return out


def inner_loops(lines) -> list:
    """The innermost loops of one function's SASS: for each backward
    branch (to a label or an address) whose span holds no other, its
    instructions and their opcodes (a Counter, predicates and modifiers
    dropped but the first, e.g. ``MUFU.EX2``)."""
    ins, labels, branches, pending = [], {}, [], []
    for line in lines:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        for lab in pending:
            labels[lab] = addr
        pending = []
        text = re.sub(r"^@!?U?P(?:\d+|T)\s+", "", text)
        op = text.split()[0] if text.split() else ""
        ins.append((addr, op))
        t = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", text)
        if op.startswith("BRA") and t:
            branches.append((addr, t.group(1) or int(t.group(2), 16)))
    spans = []
    for addr, dst in branches:
        dst = labels.get(dst, dst) if isinstance(dst, str) else dst
        if isinstance(dst, int) and dst <= addr:
            spans.append((dst, addr))
    loops = []
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue
        ops = collections.Counter(".".join(op.split(".")[:2])
                                  for a, op in ins if lo <= a <= hi)
        loops.append({"instructions": sum(ops.values()), "ops": ops})
    return loops


def per_element_step(path, lib) -> dict:
    """Instructions a state element a step of the step forward's hot loop
    (the innermost loop with the most steps; hd 64 for RWKV-6), by dtype,
    from the SASS of the library at ``path``, the steps of an iteration
    counted by their marker instruction (:data:`KERNELS`); {} without
    ``cuobjdump``."""
    fragment, marker, per_step, elems = KERNELS[lib]
    width = "Li64E" if lib == "rwkv6_scan" else "Li16E"
    out = {}
    for name, lines in sass_functions(path).items():
        if fragment not in name or width not in name:
            continue
        best = None
        for loop in inner_loops(lines):
            steps = loop["ops"][marker] / per_step
            if steps >= 1 and (best is None or steps > best[0]):
                best = (steps, loop)
        if best is None:
            continue
        steps, loop = best
        out["bfloat16" if "bfloat16" in name else "float32"] = {
            "steps_an_iteration": steps,
            "instructions": loop["instructions"],
            "per_element_step": loop["instructions"] / (steps * elems),
            "top_ops": ", ".join(f"{op} {n}" for op, n in
                                 loop["ops"].most_common(8))}
    return out


def _inputs(lib, dtype, gen):
    import torch
    dev = torch.device("cuda")

    def f(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)
    if lib == "rwkv6_scan":
        h = WIDTH[lib] // HD
        w = torch.sigmoid(torch.randn((B, T, h, HD), generator=gen,
                                      device=dev) + 2).to(dtype)
        return [f(B, T, h, HD, scale=0.5), f(B, T, h, HD, scale=0.5),
                f(B, T, h, HD), w, f(h, HD, scale=0.5),
                torch.randn((B, h, HD, HD), generator=gen, device=dev) * 0.3]
    d = WIDTH[lib]
    x = torch.randn((B, T, 1), generator=gen, device=dev)
    return [f(B, T, d), torch.nn.functional.softplus(x - 1).to(dtype),
            f(B, T, N), f(B, T, N),
            -torch.exp(torch.randn((d, N), generator=gen, device=dev) * 0.5),
            torch.randn((B, d, N), generator=gen, device=dev) * 0.3]


def _call(lib, cdll, tag, args):
    """One call of the variant's step-forward C entry: (last state, y)."""
    import torch
    s, y = torch.empty_like(args[5]), torch.empty_like(args[0])
    dims = (B, T, WIDTH[lib] // HD, HD) if lib == "rwkv6_scan" else (
        B, T, WIDTH[lib], N)
    err = getattr(cdll, f"{lib}_fwd_{tag}")(
        *[a.data_ptr() for a in args], y.data_ptr(), s.data_ptr(), *dims,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"{lib} step forward ({tag})")
    return s, y


def _graph_us(fn, reps: int) -> float:
    """Mean device µs of one ``fn()``: ``reps`` calls captured in a CUDA
    graph, CUDA events around three replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps) * 1e3


def main(argv=None) -> dict:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_fwd_variants: needs a CUDA device")
    card = variants.card()
    gen = torch.Generator(device="cuda").manual_seed(30)
    result = {"card": card, "shape": [B, T], "us": {}, "sass": {}}
    for lib, vs in VARIANTS.items():
        libs = variants.build_all(lib, vs)
        for name, subs in vs.items():
            counts = per_element_step(variants.library_path(lib, subs), lib)
            result["sass"][f"{lib} {name}"] = counts
            print(f"[variants] {lib} {name} SASS: " + "; ".join(
                f"{d} {c['per_element_step']:.3f} instructions a state "
                f"element a step ({c['top_ops']})"
                for d, c in counts.items()), flush=True)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args = _inputs(lib, dtype, gen)
            first = _call(lib, libs[next(iter(vs))], tag, args)
            for name in vs:
                got = _call(lib, libs[name], tag, args)
                if not all(torch.equal(a, b) for a, b in zip(got, first)):
                    raise SystemExit(f"{lib} {tag} {name}: not the shipped "
                                     f"source's state and y bit for bit")
            del first, got
            times = {n: [] for n in vs}
            for _ in range(opts.rounds):
                for name in vs:
                    times[name].append(_graph_us(
                        lambda: _call(lib, libs[name], tag, args), opts.reps))
            result["us"][f"{lib} {tag}"] = {
                n: {"median": statistics.median(v), "all": v}
                for n, v in times.items()}
            print(f"[variants] {lib} {tag} B={B} T={T} width={WIDTH[lib]}, "
                  f"state and y the shipped source's bit for bit; us a call, "
                  f"median of {opts.rounds} rounds (min, max): " + "; ".join(
                      f"{n} {statistics.median(v):.2f} ({min(v):.2f}, "
                      f"{max(v):.2f})" for n, v in times.items())
                  + f" ({card})", flush=True)
            del args
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
