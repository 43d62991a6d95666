"""Time the SSM step backward pairs' unit and stretch lengths against
the alternatives, in bf16 and in float32.

The step pairs (``csrc/rwkv6_scan.cu``, ``csrc/mamba_scan.cu``) keep the
state entering and the cotangent leaving every unit of tokens, then
rebuild each unit's states stretch by stretch from the one entering it.
A longer unit keeps fewer boundaries (less workspace) but rebuilds more
(RWKV-6 rebuilds each stretch from the unit's start); a longer stretch
rebuilds less but holds more states in registers.  The sources ship
both with units of 32 tokens and stretches of 8 (Mamba's stretches keep
their states and exponentials in registers for the walk back, and its
pass 2 runs four blocks an SM).  This script builds
the alternatives (:data:`VARIANTS`: each a few replacements of a copy of
the shipped source, each of which must match once), checks that each
gives the shipped gradients (within 1e-5 of the largest: a unit changes
the order of du's and da's sums), and times each at B = 2, T = 2048 and
one layer's width (RWKV-6-7B's 64 heads of 64, Jamba's 8192 Mamba
channels), CUDA events around back-to-back calls of the C entry, the
variants alternating round by round.  The workspace of each is its
boundaries and partial sums, float32.

Run on one H100 (it needs ``nvcc``; it writes under ``build/``):

    PYTHONPATH=src python -m repro_torch.launch.step_bwd_units [--rounds 5]
"""
from __future__ import annotations

import argparse
import json
import statistics

from repro_torch.kernels import build
from repro_torch.launch import variants

#: B, T and width of the timed calls (RWKV-6: heads of :data:`HD`)
B, T = 2, 2048
WIDTH = {"rwkv6_scan": 4096, "mamba_scan": 8192}
HD, N = 64, 16
_UNIT = "constexpr int kStepUnit = 32;"
_SUB = "constexpr int kSub = 8;        // tokens a stretch"
_M_UNIT = "constexpr int kStepUnitM = 32;"
_M_LB4 = ("__global__ void __launch_bounds__(kGradThreads, 4)\n"
          "mamba_step_grad_kernel")
#: the Mamba pass 2's walk back with the stretch's states and
#: exponentials recomputed, not kept (the replacement of the shipped
#: text between these two markers)
_M_KEEP_FROM = ("    // one step forward, the step forward's roundings: "
                "s_{t-1} -> s_t,\n    // and its exp")
_M_KEEP_TO = ("          // dx (lanes q < 2) and sum_n g a (q >= 2) over the "
              "channel's")
_M_RECOMPUTE = '''\
    // one step forward, the step forward's roundings: s_{t-1} -> s_t
    const auto step = [&](float (&v)[kQ], int c) {
      const float dt = sdt[c];
      const float x = rnd<T>(__fmul_rn(dt, su[c][dl]));
      float bv[kQ];
      lds4(bv, &sb[c][q * kQ]);
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        v[j] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dt, an[j])), v[j]),
                         __fmul_rn(x, bv[j]));
    };
    const auto walk = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      float ck[kNSub][kQ];
#pragma unroll
      for (int k = 0; k < kNSub; ++k) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) ck[k][j] = s[j];
#pragma unroll
        for (int c = k * kSub; c < (k + 1) * kSub; ++c)
          if (kWhole || c < len) step(s, c);
      }
#pragma unroll
      for (int k = kNSub - 1; k >= 0; --k) {
        if (!kWhole && k * kSub >= len) continue;
        float sp[kSub][kQ];
#pragma unroll
        for (int c = 0; c < kSub; ++c) {
#pragma unroll
          for (int j = 0; j < kQ; ++j) sp[c][j] = c ? sp[c - 1][j] : ck[k][j];
          if (c && (kWhole || k * kSub + c - 1 < len))
            step(sp[c], k * kSub + c - 1);
        }
#pragma unroll
        for (int c8 = kSub - 1; c8 >= 0; --c8) {
          const int c = k * kSub + c8;
          if (!kWhole && c >= len) continue;
          const float dt = sdt[c], uv = su[c][dl], dyv = sdy[c][dl];
          const float x = rnd<T>(__fmul_rn(dt, uv));
          float bv[kQ], cv[kQ], p[2 * kQ];
          lds4(bv, &sb[c][q * kQ]);
          lds4(cv, &sc[c][q * kQ]);
          float dx = 0.f, ga = 0.f;
#pragma unroll
          for (int j = 0; j < kQ; ++j) {
            const float e = expf(__fmul_rn(dt, an[j]));
            const float s_t =
                __fadd_rn(__fmul_rn(e, sp[c8][j]), __fmul_rn(x, bv[j]));
            h[j] = fmaf(dyv, cv[j], h[j]);
            p[kQ + j] = dyv * rnd<T>(s_t);
            p[j] = h[j] * x;
            dx = fmaf(h[j], bv[j], dx);
            const float g = h[j] * sp[c8][j] * e;
            da[j] = fmaf(g, dt, da[j]);
            ga = fmaf(g, an[j], ga);
            h[j] *= e;
          }
'''


def _m_keep() -> str:
    """The shipped Mamba pass 2's text between the two markers."""
    text = (build.SRC_DIR / "mamba_scan.cu").read_text()
    a = text.index(_M_KEEP_FROM)
    return text[a:text.index(_M_KEEP_TO, a)]


#: each library's variants as (unit, replacements of the shipped source)
VARIANTS = {
    "rwkv6_scan": {
        "unit 32, stretch 8": (32, []),
        "unit 16, stretch 8": (16, [(_UNIT, "constexpr int kStepUnit = 16;")]),
        "unit 64, stretch 8": (64, [(_UNIT, "constexpr int kStepUnit = 64;")]),
        "unit 32, stretch 4": (32, [(_SUB, "constexpr int kSub = 4;        "
                                           "// tokens a stretch")]),
    },
    "mamba_scan": {
        "unit 32, stretch kept": (32, []),
        "unit 32, stretch recomputed": (32, None),
        "unit 64, stretch kept": (64, [(_M_UNIT,
                                        "constexpr int kStepUnitM = 64;")]),
        "unit 32, three blocks an SM": (32, [(_M_LB4, _M_LB4.replace(
            ", 4)", ", 3)"))]),
    },
}


def _subs(lib, subs):
    return [(_m_keep(), _M_RECOMPUTE)] if subs is None else subs


def workspace_bytes(lib: str, unit: int) -> int:
    """The step pair's workspace at :data:`B`, :data:`T`, its width."""
    n_u = -(-T // unit)
    if lib == "rwkv6_scan":
        h = WIDTH[lib] // HD
        return n_u * B * h * HD * (2 * HD + 1) * 4
    d = WIDTH[lib]
    return (3 * B * n_u * d * N + -(-d // 256) * B * T * (2 * N + 1)) * 4


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
        args = [f(B, T, h, HD, scale=0.5), f(B, T, h, HD, scale=0.5),
                f(B, T, h, HD), w, f(h, HD, scale=0.5),
                torch.randn((B, h, HD, HD), generator=gen, device=dev) * 0.3]
    else:
        d = WIDTH[lib]
        x = torch.randn((B, T, 1), generator=gen, device=dev)
        args = [f(B, T, d), torch.nn.functional.softplus(x - 1).to(dtype),
                f(B, T, N), f(B, T, N),
                -torch.exp(torch.randn((d, N), generator=gen, device=dev)
                           * 0.5),
                torch.randn((B, d, N), generator=gen, device=dev) * 0.3]
    ds = torch.randn(args[5].shape, generator=gen, device=dev)
    dy = torch.randn(args[0].shape, generator=gen, device=dev).to(dtype)
    return args, ds, dy


def _call(lib, cdll, unit, tag, args, ds, dy):
    """One call of the variant's C entry: the six gradients."""
    import torch
    f32 = dict(dtype=torch.float32, device=args[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    ws = torch.empty(workspace_bytes(lib, unit) // 4, **f32)
    if lib == "rwkv6_scan":
        r, k, v, w, u, s0 = args
        h = r.shape[2]
        outs = [torch.empty_like(r) for _ in range(4)] + [
            torch.empty(u.shape, **f32), torch.empty_like(s0)]
        err = getattr(cdll, f"rwkv6_scan_bwd_{tag}")(
            *[a.data_ptr() for a in args], dy.data_ptr(), ds.data_ptr(),
            ws.data_ptr(), *[o.data_ptr() for o in outs], B, T, h, HD,
            stream)
    else:
        u, d = args[0], args[0].shape[2]
        outs = [torch.empty_like(u), torch.empty((B, T, 2 * N + 1), **f32),
                torch.empty((d, N), **f32), torch.empty_like(args[5])]
        err = getattr(cdll, f"mamba_scan_bwd_{tag}")(
            *[a.data_ptr() for a in args], dy.data_ptr(), ds.data_ptr(),
            ws.data_ptr(), *[o.data_ptr() for o in outs], B, T, d, N,
            stream)
    build.check(err, f"{lib} step backward ({tag})")
    return outs


def main(argv=None) -> dict:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_bwd_units: needs a CUDA device")
    card = variants.card()
    gen = torch.Generator(device="cuda").manual_seed(29)
    result = {"card": card, "shape": [B, T], "us": {}}
    for lib, vs in VARIANTS.items():
        libs = variants.build_all(lib, {n: _subs(lib, s)
                                        for n, (_, s) in vs.items()})
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args, ds, dy = _inputs(lib, dtype, gen)

            def call(name):
                return _call(lib, libs[name], vs[name][0], tag, args, ds, dy)

            first = call(next(iter(vs)))
            for name in vs:
                for i, (a, b) in enumerate(zip(call(name), first)):
                    err = (a.float() - b.float()).abs().max().item()
                    if err > 1e-5 * b.float().abs().max().item():
                        raise SystemExit(f"{lib} {tag} {name}: gradient {i} "
                                         f"{err} from the shipped source's")
            del first
            times = {n: [] for n in vs}
            for _ in range(opts.rounds):
                for name in vs:
                    call(name)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(opts.reps):
                        call(name)
                    stop.record()
                    torch.cuda.synchronize()
                    times[name].append(start.elapsed_time(stop) / opts.reps
                                       * 1e3)
            result["us"][f"{lib} {tag}"] = {
                n: {"median": statistics.median(v), "all": v,
                    "workspace_bytes": workspace_bytes(lib, vs[n][0])}
                for n, v in times.items()}
            print(f"[units] {lib} {tag} B={B} T={T} width={WIDTH[lib]}, "
                  f"gradients within 1e-5 of the shipped source's; us a "
                  f"call, median of {opts.rounds} rounds of {opts.reps} "
                  f"(min, max), workspace GB: " + "; ".join(
                      f"{n} {statistics.median(v):.1f} ({min(v):.1f}, "
                      f"{max(v):.1f}), "
                      f"{workspace_bytes(lib, vs[n][0]) / 1e9:.4f}"
                      for n, v in times.items()) + f" ({card})", flush=True)
            del args, ds, dy
            torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
