"""Dry run: one step of every (arch x shape x mesh) cell on a fake
production mesh, counted per device, with nothing allocated.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell against 512 forced host devices and reads the
compiled module's memory and cost.  Here one process joins a fake
process group (``torch``'s ``FakeStore``: every collective returns at
once) as rank 0 of 256 or 512, builds the production ``DeviceMesh``,
places parameters, optimizer state, caches and inputs as DTensors whose
local shards are ``FakeTensorMode`` tensors (shapes and dtypes, no
memory) by :func:`repro_torch.launch.mesh.param_spec` and
:func:`cache_specs`, and runs one train step, prefill or decode step of
the port's model under :class:`repro_torch.launch.cost.CostCounter`.

* FLOPs and bytes are the local matrix products' (per device); the
  collective bytes are those of the collectives DTensor and the MoE
  mesh variants run, by kind.
* Memory per device is counted from local shard sizes: the arguments
  (parameters, optimizer state, caches, inputs), the outputs, the part
  of the outputs that is an argument updated in place (the cache, the
  parameters), and the peak of the operations' live outputs.
* The SSM scans (:func:`repro_torch.models.ssm._rwkv6_scan`,
  ``_mamba_scan``: a Python loop, one step a token) run their first two
  steps, and the second is counted once for every step after the first
  (:func:`scan_shortcut`), as the reference counts a ``while`` body
  times its trip count: a step's cost does not depend on its values, so
  the total is the full loop's (``tests/test_torch_dryrun.py`` holds the
  two equal), in seconds where the loop took minutes.  Serving and
  training keep the loop.
* An operation DTensor has no sharding strategy for (or cannot
  propagate on fake tensors) runs on replicated arguments instead (with
  no strategy at all, on each rank's whole tensors): the counter sees
  the all-gathers that costs, and the record lists each such operation
  under ``replicated_ops`` with its count.  Nothing is
  skipped silently: a cell that cannot run says why.

Run one cell as its own process (``dryrun_all`` drives one per cell)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch kimi_k2_1t_a32b --shape decode_32k [--multi-pod]

``--smoke`` runs the config's smoke variant at small shapes on a fake
2 x 2 mesh (the CPU tests' cell).  The JSON keys are the reference's;
``xla_flops`` / ``xla_bytes`` are -1 (there is no compiler cost
analysis here, as the reference writes when it has none), and
``generated_code_size_in_bytes`` is absent.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import Counter
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ArchConfig, get, param_count, smoke
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.cost import KINDS, CostCounter
from repro_torch.models.model import SSM_KINDS, build_model, group_pattern
from repro_torch.models.sharding import (axis_sizes, data_axes, data_size,
                                         placements, use_mesh)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

#: the shapes of a ``--smoke`` cell (smoke config, fake 2 x 2 mesh)
SMOKE_SHAPES = {
    "train_4k": dict(kind="train", seq=32, batch=8),
    "prefill_32k": dict(kind="prefill", seq=32, batch=8),
    "decode_32k": dict(kind="decode", seq=64, batch=8),
    "long_500k": dict(kind="decode", seq=128, batch=1),
}
SMOKE_MESH = ((2, 2), ("data", "model"))


def shape_skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 524k-token cache at batch=1 is "
                "out of scope per the shape table (DESIGN.md §6)")
    return None


# ---------------------------------------------------------------------------
# input specs (shape and dtype stand-ins)
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: str,
                shapes: Dict = SHAPES) -> Dict[str, Tuple[tuple,
                                                          torch.dtype]]:
    """``{name: (shape, dtype)}`` of the cell's inputs."""
    info = shapes[shape]
    b = info["batch"]
    out: Dict[str, Tuple[tuple, torch.dtype]] = {}
    if info["kind"] in ("train", "prefill"):
        out["tokens"] = ((b, info["seq"]), torch.int32)
    else:  # decode: one new token against a seq-long cache
        out["tokens"] = ((b, 1), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = ((b, cfg.enc_len, cfg.d_model), cfg.torch_dtype)
    if cfg.family == "vlm":
        out["patches"] = ((b, cfg.n_patches, cfg.d_model), cfg.torch_dtype)
    return out


def cache_specs(cfg: ArchConfig, batch: int, seq: int, mesh,
                seq_sharded: bool) -> Tuple[Any, Any]:
    """``(cache, specs)``: the decode cache of ``Model.init_cache`` on the
    meta device, and a spec per tensor, the reference's rules for the
    port's layouts (no stacked group axis):

    * KV ``(B, Hkv, T, hd)``: T on ``model`` (sequence-parallel; batch=1
      long-context cells also spread T over the data axes), batch on the
      data axes where it divides;
    * RWKV ``S`` ``(B, H, hd, hd)``: heads on ``model``; its token-shift
      carry ``(B, d)`` and Mamba's ``(B, d, N)``: d on ``model``.
    """
    model = build_model(cfg)
    caches, states = model.init_cache(batch, seq, device="meta")
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    n_dp = data_size(mesh)

    def b_ax(shp):
        return dp if shp[0] % n_dp == 0 else None

    def on_model(n):
        return "model" if n % sizes["model"] == 0 else None

    def kv(t):
        shp = t.shape
        t_axes = (tuple(dp) + ("model",)) if seq_sharded else ("model",)
        n_t = 1
        for a in t_axes:
            n_t *= sizes[a]
        return (None if seq_sharded else b_ax(shp), None,
                t_axes if shp[2] % n_t == 0 else None, None)

    def state(kind, st):
        if kind == "rwkv":
            s, x_last = st
            return ((b_ax(s.shape), on_model(s.shape[1]), None, None),
                    (b_ax(x_last.shape), on_model(x_last.shape[1])))
        return (b_ax(st.shape), on_model(st.shape[1]), None)

    ssm = [k for k in group_pattern(cfg) if k in SSM_KINDS]
    cspec = (None if caches is None else
             [[(kv(k), kv(v)) for k, v in g] for g in caches])
    sspec = (None if states is None else
             [[state(kind, st) for kind, st in zip(ssm, g)] for g in states])
    return (caches, states), (cspec, sspec)


# ---------------------------------------------------------------------------
# fake, sharded tensors
# ---------------------------------------------------------------------------


class _DTensorOps(TorchDispatchMode):
    """How the dry run dispatches a DTensor operation.

    * Outside the ambient ``FakeTensorMode``: the step's factory calls
      must make fake tensors, but DTensor's sharding propagation computes
      with small real tensors of its own (shard sizes and offsets), which
      a fake mode turns data-dependent.  The local shards are fake tensors
      and stay so.
    * An operation that fails to propagate its sharding runs on
      replicated arguments instead, and one with no strategy at all on
      every rank's whole (replicated) tensors; such operations are
      counted by name.
    """

    def __init__(self):
        super().__init__()
        self.replicated: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        with unset_fake_temporarily():
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError, AssertionError):
                self.replicated[func.name()] += 1

            def full(a):
                if isinstance(a, DTensor):
                    return a.redistribute(a.device_mesh,
                                          [Replicate()] * a.device_mesh.ndim)
                return a

            args, kwargs = tree_map(full, args), tree_map(full, kwargs)
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError, AssertionError):
                pass  # no strategy for any placement, or a plain ``self``
            # every rank runs it on the whole (replicated) tensors
            mesh = next(a.device_mesh for a in args
                        if isinstance(a, DTensor))
            local, back = {}, {}  # DTensor -> its local; local -> argument
            for a in args:
                if isinstance(a, DTensor):
                    local[id(a)] = a.to_local()
                    back[id(local[id(a)])] = a
                elif isinstance(a, torch.Tensor):
                    back[id(a)] = a

            def unwrap(a):
                return local.get(id(a), a) if isinstance(a, DTensor) else a

            def wrap(o):
                if not isinstance(o, torch.Tensor):
                    return o
                if id(o) in back:  # an in-place result: the argument
                    return back[id(o)]
                return DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                          run_check=False)

            return tree_map(wrap, func(*tree_map(unwrap, args),
                                       **tree_map(unwrap, kwargs)))


@contextlib.contextmanager
def scan_shortcut(counter: CostCounter) -> Iterator[None]:
    """Inside the block, the SSM scans run their first two time steps
    and count the second ``T - 1`` times, its backward too (module
    docstring); their outputs keep the full loop's shapes (the second
    step's output stands for the later ones: the dry run reads no
    values)."""
    from repro_torch.models import ssm
    real = {n: getattr(ssm, n) for n in ("_rwkv6_scan", "_mamba_scan")}

    def shortcut(scan):
        # both scans: four (B, T, ...) inputs, one constant, the state
        def run(a, b, c, d, const, s):
            n_t = a.shape[1]
            if n_t <= 2:
                return scan(a, b, c, d, const, s)
            s, y0 = scan(*(x[:, :1] for x in (a, b, c, d)), const, s)
            s, y1 = _Repeated.apply(counter, n_t - 1, scan, const, s,
                                    *(x[:, 1:2] for x in (a, b, c, d)))
            shape = list(y1.shape)
            shape[1] = n_t - 1
            return s, torch.cat([y0, y1.expand(shape)], dim=1)
        return run

    for n, scan in real.items():
        setattr(ssm, n, shortcut(scan))
    try:
        yield
    finally:
        for n, scan in real.items():
            setattr(ssm, n, scan)


class _Repeated(torch.autograd.Function):
    """One scan step whose forward and backward are each counted ``n``
    times: the step runs on its own autograd graph, whose gradient the
    backward takes inside :meth:`CostCounter.repeat`.  That graph keeps
    its saved tensors itself (an activation checkpoint around the step
    would otherwise recompute its whole region inside the repeat)."""

    @staticmethod
    def forward(ctx, counter, n, scan, const, s, *xs):
        # an output nobody uses gets no gradient (a materialised plain
        # zero would not be a DTensor)
        ctx.set_materialize_grads(False)
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in (const, s) + xs]
        keep = torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                        lambda t: t)
        with torch.enable_grad(), keep, counter.repeat(n):
            s_out, y = scan(*ins[2:], ins[0], ins[1])
        ctx.counter, ctx.n, ctx.ins, ctx.outs = counter, n, ins, (s_out, y)
        return s_out.detach(), y.detach()

    @staticmethod
    def backward(ctx, g_s, g_y):
        want = [t for t in ctx.ins if t.requires_grad]
        outs = [(o, g) for o, g in zip(ctx.outs, (g_s, g_y))
                if o.requires_grad and g is not None]
        got = iter(())
        if want and outs:
            with ctx.counter.repeat(ctx.n):
                got = iter(torch.autograd.grad(
                    [o for o, _ in outs], want, [g for _, g in outs],
                    allow_unused=True))
        return (None, None, None) + tuple(
            next(got, None) if t.requires_grad else None for t in ctx.ins)


def _place(t: torch.Tensor, spec, mesh, fake) -> Any:
    """A DTensor of fake local shards for the meta tensor ``t``."""
    from torch.distributed.tensor import DTensor, Replicate
    with fake:
        full = torch.empty(t.shape, dtype=t.dtype)
    out = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return out.redistribute(mesh, placements(spec, mesh))


def _map_specs(fn, tree, specs):
    if isinstance(tree, (list, tuple)) and not torch.is_tensor(tree):
        return type(tree)(_map_specs(fn, t, s) for t, s in zip(tree, specs))
    if tree is None:
        return None
    return fn(tree, specs)


def _local_ids(tree) -> Dict[int, int]:
    """``{id: bytes of its local shard}`` of every tensor in ``tree``."""
    from torch.utils._pytree import tree_leaves
    out = {}
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            local = t.to_local() if hasattr(t, "to_local") else t
            out[id(t)] = local.numel() * local.element_size()
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, multi_pod: bool,
             dispatch: str = "spec", extra_tags: str = "",
             smoke_cell: bool = False, full_scans: bool = False) -> Dict:
    """Run one cell and return its record (printed as one JSON line).
    ``full_scans`` runs the SSM scans' every step instead of
    :func:`scan_shortcut`."""
    cfg = get(arch)
    mesh_name = "multi" if multi_pod else "single"
    reason = shape_skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "skipped": reason}
    shapes = SMOKE_SHAPES if smoke_cell else SHAPES
    if smoke_cell:
        cfg = smoke(cfg)
        mesh_shape, axes = SMOKE_MESH
    else:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n_dev = 1
    for n in mesh_shape:
        n_dev *= n
    t0 = time.perf_counter()
    with mesh_mod.process_group("fake", n_dev):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=axes)
        out = _run(cfg, shape, shapes[shape], mesh, dispatch, full_scans)
    total, active = param_count(cfg)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "n_devices": n_dev, "dispatch": dispatch, "tags": extra_tags,
        "params_total": total, "params_active": active,
        # no compiler cost analysis here (the reference's -1 for none)
        "xla_flops": -1, "xla_bytes": -1,
        "flops": out["cost"]["dot_flops"],
        "bytes_accessed": out["cost"]["dot_bytes"],
        "collective_bytes": _by_kind(out["cost"]),
        # as the reference's dry run counts them (16-bit floating
        # reductions at 4 bytes an element): for comparing with it only
        "collective_bytes_xla_cpu": _by_kind(out["xla_cpu"]),
        "collective_calls": out["calls"],
        "param_bytes": out["param_bytes"],
        "replicated_ops": out["replicated_ops"],
        "seconds": time.perf_counter() - t0,
        "memory_analysis": out["memory"],
    }
    if smoke_cell:
        rec["smoke"] = {"shape": shapes[shape], "mesh": list(mesh_shape)}
    print(json.dumps({k: v for k, v in rec.items()
                      if k != "memory_analysis"}, indent=None))
    print("memory_analysis:", rec["memory_analysis"])
    return rec


def _by_kind(totals: Dict[str, float]) -> Dict[str, float]:
    """Collective bytes by kind (0 where none ran) and their total."""
    return {k: totals.get(k, 0.0) for k in KINDS} | {
        "total": totals["collective_total"]}


def _run(cfg: ArchConfig, shape: str, info: Dict, mesh,
         dispatch: str, full_scans: bool = False) -> Dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    model = build_model(cfg, dispatch=dispatch)
    dp = data_axes(mesh)
    batch_sharded = info["batch"] % data_size(mesh) == 0
    kind = info["kind"]
    fsdp = kind == "train" and mesh_mod.needs_fsdp(cfg)

    meta = model.init(torch.Generator(), "meta")
    if kind == "train":
        from repro_torch.train.train_step import TrainState, make_optimizer
        (opt_init, _), _ = make_optimizer(cfg)
        meta = TrainState(meta, opt_init(meta),
                          torch.zeros((), dtype=torch.int32, device="meta"))
    # parameters and optimizer state by the parameter rules, on their
    # paths (``opt/m/groups/s1_moe/w_gate`` shards as the weight does)
    placed = mesh_mod.map_paths(lambda path, t: _place(
        t, mesh_mod.param_spec(path, tuple(t.shape), cfg, mesh, fsdp),
        mesh, fake) if torch.is_tensor(t) else t, meta)
    params = placed.params if kind == "train" else placed

    def inp(shp, dtype, sharded=True):
        spec = ((dp if sharded and batch_sharded else None),) + \
            (None,) * (len(shp) - 1)
        return _place(torch.empty(shp, dtype=dtype, device="meta"), spec,
                      mesh, fake)

    ins = {k: inp(s, dt) for k, (s, dt) in
           input_specs(cfg, shape, {shape: info}).items()}
    memory = ins.get("frames", ins.get("patches"))
    fallback = _DTensorOps()
    counter = CostCounter()
    scans = (contextlib.nullcontext() if full_scans
             else scan_shortcut(counter))
    with use_mesh(mesh), implicit_replication():
        if kind == "train":
            from repro_torch.train.train_step import make_train_step
            _, train_step, _ = make_train_step(model)
            state = placed
            batch = {"tokens": ins["tokens"]}
            if memory is not None:
                batch["frames" if cfg.family == "encdec" else
                      "patches"] = memory
            args = (state, batch)
            with fake, counter, fallback, scans:
                outputs = train_step(state, batch)
        else:
            seq_sharded = kind == "decode" and not batch_sharded
            cache, cspecs = cache_specs(cfg, info["batch"], info["seq"],
                                        mesh, seq_sharded)
            cache = tuple(_map_specs(lambda t, s: _place(t, s, mesh, fake),
                                     c, sp) for c, sp in zip(cache, cspecs))
            args = (params, cache, ins)
            with fake, counter, fallback, scans:
                if kind == "prefill":
                    mem = memory
                    if cfg.family == "encdec":
                        mem = model._encode(params, mem)
                    outputs = model._forward(params, ins["tokens"], cache,
                                             0, model._make_cross(params,
                                                                  mem),
                                             None, False)
                else:
                    mem = memory
                    if cfg.family == "encdec":
                        mem = model._encode(params, mem)
                    outputs = model.decode_step(params, cache, ins["tokens"],
                                                info["seq"] - 1, memory=mem)
    arg_ids = _local_ids(args)
    out_ids = _local_ids(outputs)
    return {
        "cost": counter.totals(),
        "xla_cpu": counter.xla_cpu_totals(),
        "calls": dict(counter.collective_calls),
        "param_bytes": sum(_local_ids(params).values()),
        "replicated_ops": dict(fallback.replicated),
        "memory": {
            "argument_size_in_bytes": sum(arg_ids.values()),
            "output_size_in_bytes": sum(out_ids.values()),
            "alias_size_in_bytes": sum(n for i, n in out_ids.items()
                                       if i in arg_ids),
            "temp_size_in_bytes": counter.peak_bytes,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dispatch", default="spec",
                    choices=("spec", "spec-kernel", "dense"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tags", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run_cell(args.arch, args.shape, args.multi_pod,
                   dispatch=args.dispatch, extra_tags=args.tags,
                   smoke_cell=args.smoke)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=2)
    return 0 if ("skipped" in res or res.get("flops", -1) != 0) else 1


if __name__ == "__main__":
    sys.exit(main())
