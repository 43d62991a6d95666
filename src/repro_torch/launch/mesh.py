"""Production mesh and sharding rules.

The counterpart of the JAX package's ``launch/mesh.py``, on
``torch.distributed``'s ``DeviceMesh`` and DTensor placements.
:func:`make_production_mesh` is a function (importing the module touches
no process group): single-pod ``(16, 16)`` over ``("data", "model")``,
multi-pod ``(2, 16, 16)`` over ``("pod", "data", "model")``, the
reference's shapes and names, so that the MoE variant each config takes
is the reference's (Grok-1's 8 experts go tensor-parallel, Kimi-K2's 384
expert-parallel).  The caller starts the process group of 256 or 512
ranks (:mod:`repro_torch.launch.dryrun` uses a fake one).

Sharding policy, the reference's:

* batch over ``(pod, data)``;
* TP over ``model``: attention heads / FFN width / vocab;
* EP folded into ``model``: experts shard over it when ``E % model == 0``
  (Kimi-K2: 384/16), else the expert FFN dim shards (Grok-1: 8 experts);
* FSDP: parameters and optimizer state additionally shard their largest
  replicated dim over ``data`` for configs above :func:`needs_fsdp`'s
  threshold.

A spec is a tuple with one entry per dimension (None, an axis name or a
tuple of names), as a ``PartitionSpec``;
:func:`repro_torch.models.sharding.placements` turns it into DTensor
placements.  The rules key on the parameter's path
(``groups/s1_moe/w_gate``, ``embed``, ...).  The port keeps one
dictionary per layer group, so a group's leaf has the per-layer shape
(``(384, 7168, 2048)``) where the reference's stacked leaf has a leading
group axis; :func:`param_spec` gives both the reference's answer, but
only the per-layer shape reaches the sharded branches (the reference's
4-D stacked experts and 3-D stacked projections fall through to
replicated).  ``auto_axis_types`` is JAX's mesh-mode keyword and has no
counterpart here.
"""
from __future__ import annotations

import contextlib
import re
import socket
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

from ..configs.base import ArchConfig, param_count
from ..models.sharding import axis_sizes, data_axes, placements

Spec = Tuple[Any, ...]


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0,
                  init_method: Optional[str] = None) -> Iterator[None]:
    """The default process group for the block, destroyed after it:
    ``"gloo"`` or ``"nccl"`` through ``init_method`` (a fresh
    ``tcp://localhost`` port when None, enough for one rank), or
    ``"fake"``: ``world_size`` ranks of which this process is ``rank``,
    every collective a no-op (``torch``'s ``FakeStore``), for the dry
    run."""
    import torch.distributed as dist
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)
    else:
        dist.init_process_group(
            backend, init_method=init_method
            or f"tcp://localhost:{free_port()}", rank=rank,
            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the running process group (256
    or 512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------


def param_spec(path: str, shape: Tuple[int, ...], cfg: ArchConfig,
               mesh, fsdp: bool) -> Spec:
    """The spec of one parameter, keyed on its path."""
    sizes = axis_sizes(mesh)
    model_n = sizes["model"]
    data_n = sizes["data"]
    fs = "data" if fsdp else None

    if len(shape) <= 1 or "ln" in path:      # norms, biases, vectors
        return (None,) * len(shape)

    # --- embeddings / head: vocab on model, d on data(FSDP) ---------------
    if ("embed" in path or "lm_head" in path) and len(shape) == 2:
        v_dim = 0 if "embed" in path else 1
        spec = [None] * len(shape)
        if shape[v_dim] % model_n == 0:
            spec[v_dim] = "model"
        if fsdp and shape[1 - v_dim] % data_n == 0:
            spec[1 - v_dim] = fs
        return tuple(spec)

    # --- MoE experts -------------------------------------------------------
    if re.search(r"(w_gate|w_up|w_down)$", path) and len(shape) == 3:
        e, a, b = shape
        if e % model_n == 0:                       # EP on the model axis
            spec = ["model", None, None]
            if fsdp and a % data_n == 0:
                spec[1] = fs
            return tuple(spec)
        # few experts: shard the FFN dim (TP inside each expert)
        ff_dim = 2 if "w_down" not in path else 1
        spec = [None, None, None]
        if shape[ff_dim] % model_n == 0:
            spec[ff_dim] = "model"
        other = 1 if ff_dim == 2 else 2
        if fsdp and shape[other] % data_n == 0:
            spec[other] = fs
        return tuple(spec)

    if "router" in path:
        return (None, None)

    # --- attention / dense MLP / SSM projections (2-D) ---------------------
    if len(shape) == 2:
        # column-parallel by default (wq/wk/wv/w_gate/w_up/in_proj...)
        # row-parallel for the contraction-side mats (wo / w_down / out_proj)
        row_parallel = bool(re.search(r"(wo|w_down|out_proj)$", path))
        tp_dim = 0 if row_parallel else 1
        spec = [None, None]
        if shape[tp_dim] % model_n == 0:
            spec[tp_dim] = "model"
        if fsdp and shape[1 - tp_dim] % data_n == 0 \
                and spec[1 - tp_dim] is None:
            spec[1 - tp_dim] = fs
        return tuple(spec)

    return (None,) * len(shape)


def map_paths(fn: Callable[[str, Any], Any], tree: Any,
              path: str = "") -> Any:
    """``fn(path, leaf)`` over dictionaries, lists and named tuples; a
    list index is not part of the path (the reference stacks groups)."""
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return type(tree)(**{k: map_paths(fn, v, _join(path, k))
                             for k, v in tree._asdict().items()})
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, _join(path, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, v, path) for v in tree)
    return fn(path, tree)


def _join(path: str, key: str) -> str:
    return f"{path}/{key}" if path else key


def shard_pytree_specs(tree: Any, cfg: ArchConfig, mesh,
                       fsdp: bool) -> Any:
    """The tree's placements: a list of placements at each tensor (or
    anything with a ``shape``), None at any other leaf."""
    def one(path, leaf):
        if not hasattr(leaf, "shape"):
            return None
        return placements(
            param_spec(path, tuple(leaf.shape), cfg, mesh, fsdp), mesh)

    return map_paths(one, tree)


def distribute_params(params: Any, cfg: ArchConfig, mesh,
                      fsdp: bool = False) -> Any:
    """Place a tree of full tensors (the output of
    :func:`repro_torch.models.convert.params_from_numpy`, a restored
    checkpoint) on ``mesh`` by :func:`param_spec`: each rank keeps its
    shard of every tensor as a DTensor.  Every rank must hold the same
    full values (no data moves; each rank slices its own shard)."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        spec = param_spec(path, tuple(leaf.shape), cfg, mesh, fsdp)
        full = DTensor.from_local(leaf.to(mesh.device_type), mesh,
                                  [Replicate()] * mesh.ndim,
                                  run_check=False)
        return full.redistribute(mesh, placements(spec, mesh))

    return map_paths(one, params)


def needs_fsdp(cfg: ArchConfig) -> bool:
    total, _ = param_count(cfg)
    return total * 2 > 8e9      # >8 GB of bf16 params per TP shard group


def batch_spec(mesh, *, shard_batch: bool = True,
               seq_axis: bool = False) -> Spec:
    """Token batches: batch dim over (pod, data); long-context single-batch
    cells shard the sequence dim instead (SP)."""
    if seq_axis:
        return (None, data_axes(mesh))
    return (data_axes(mesh), None)

