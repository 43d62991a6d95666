"""Activation sharding constraints and the ambient mesh.

The counterpart of the JAX package's ``models/sharding.py``.  JAX reads
the mesh of an enclosing ``with mesh:``; the port's ambient mesh is set
by :func:`use_mesh` (a ``torch.distributed`` ``DeviceMesh`` with named
dimensions) and read by :func:`current_mesh`.

``constrain(x, ...)`` applies a per-dimension spec (None, an axis name or
a tuple of names, as a ``PartitionSpec`` entry) with the reference's
rules: the pseudo-axis ``"dp"`` expands to ``("pod", "data")`` on
multi-pod meshes (``("data",)`` otherwise), and an axis missing from the
mesh, or one whose size does not divide the dimension, drops to None.
The spec becomes DTensor placements (:func:`placements`) and a DTensor
argument is redistributed to them.  A plain tensor, or any tensor with no
ambient mesh, is returned as it is, so every meshless path and every
path over plain (replicated) tensors is unchanged, bit for bit.

Where DTensor's own propagation would gather what the reference's
compiled program keeps sharded, the layers work on local shards with the
helpers here: :func:`local` (this rank's shard of a DTensor, or of a
plain tensor that every rank holds whole), :func:`shard_span` (where a
rank's shard of a dimension starts), :func:`unshard` (replicate a
DTensor over some mesh dimensions: the FSDP gather of a weight) and
:func:`reduce` (a ``constrain`` whose partial sums are reduced once,
through :class:`SumAcross`, an all-reduce whose gradient passes
through); :func:`local_call` runs a device loop whose rows are
independent (the SSM scans, chunked attention) on each rank's shards.
Every reduction runs in its tensor's dtype, as the reference's psums
do.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axis = Union[None, str, Tuple[str, ...]]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` the ambient mesh inside the block (JAX's
    ``with mesh:``); ``use_mesh(None)`` clears it."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The ambient ``DeviceMesh``, or None."""
    return _MESH.get()


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a named ``DeviceMesh`` (the reference's
    ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ``("pod", "data")`` or ``("data",)``."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def data_size(mesh) -> int:
    """The number of data-parallel shards (the data axes' sizes' product)."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def resolve_spec(shape: Sequence[int], axes: Sequence[Axis],
                 mesh) -> Tuple[Axis, ...]:
    """The spec that ``constrain`` applies to a tensor of ``shape`` on
    ``mesh``: ``"dp"`` expanded, unknown or non-dividing axes dropped."""
    sizes = axis_sizes(mesh)
    spec: List[Axis] = []
    for dim, a in enumerate(axes):
        if a == "dp":
            a = data_axes(mesh)
        if a is None:
            spec.append(None)
            continue
        tup = a if isinstance(a, tuple) else (a,)
        if not all(b in sizes for b in tup):
            spec.append(None)
            continue
        n = 1
        for b in tup:
            n *= sizes[b]
        spec.append(a if shape[dim] % n == 0 else None)
    return tuple(spec)


def placements(spec: Sequence[Axis], mesh) -> list:
    """DTensor placements for a spec: mesh dimension ``i`` shards the
    tensor dimension that names it, and replicates where none does.  A
    tuple entry shards one tensor dimension over several mesh dimensions,
    the first named outermost (the mesh lists ``pod`` before ``data``)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, a in enumerate(spec):
        for b in (a if isinstance(a, tuple) else (a,) if a else ()):
            out[mesh.mesh_dim_names.index(b)] = Shard(dim)
    return out


def constrain(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """Redistribute a DTensor to ``axes`` on the ambient mesh (each entry
    None / axis name / tuple of names; unknown or non-dividing axes drop
    to None); any other tensor, or no mesh, passes through.  The
    gradient goes back to the input's placements, as with_sharding_
    constraint's transpose constrains the cotangent (a gradient that
    arrives as a partial sum is reduced there)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_spec(x.shape, axes, mesh)
    return _Constrain.apply(x, mesh, tuple(placements(spec, mesh)))


class _Constrain(torch.autograd.Function):
    """``x.redistribute(mesh, pl)``, whose backward redistributes the
    gradient to ``x``'s placements (a partial one there replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        from torch.distributed.tensor import Replicate
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.back), None, None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _mesh_dims(mesh, names: Sequence[str]) -> List[int]:
    return [mesh.mesh_dim_names.index(a) for a in names
            if a in mesh.mesh_dim_names]


def local(t: torch.Tensor, mesh, pl: Sequence,
          partial: Sequence[str] = ()) -> torch.Tensor:
    """This rank's shard of ``t`` under DTensor placements ``pl``: a
    DTensor is redistributed and unwrapped; a plain tensor is the same
    full value on every rank and is sliced, mesh dimension by mesh
    dimension, the first outermost.  ``partial`` names the mesh axes
    over which the local result's gradient is a partial sum (each rank
    uses the replicated value for its own part of the work), so that
    autograd sums it there."""
    if is_dtensor(t):
        from torch.distributed.tensor import Partial
        dims = _mesh_dims(mesh, partial)
        grad = [Partial() if i in dims and not p.is_shard() else p
                for i, p in enumerate(pl)]
        return t.redistribute(mesh, list(pl)).to_local(
            grad_placements=grad)
    for i, p in enumerate(pl):
        if p.is_shard():
            t = t.chunk(mesh.size(i), p.dim)[mesh.get_coordinate()[i]]
    return t


def local_call(fn, args, dims):
    """``fn(*args)`` on each rank's local shards when an argument is a
    DTensor: a device loop (an SSM scan, chunked attention) whose batch
    rows and heads or channels are independent, so that no rank needs
    another's part.

    ``dims`` is ``(in_dims, out_dims)``: for each argument, then for each
    output, a map from the first argument's batch and head or channel
    dimensions to its own.  Every mesh dimension shards the first
    argument on one of those or none; an argument sharded as that
    implies is taken as its local shard, a replicated one (a plain
    tensor, or a DTensor replicated there) is sliced to this rank's
    part, and its gradient is then a partial sum over that mesh
    dimension, for autograd to reduce outside.  Nothing is gathered, in
    the forward or the backward; an argument sharded any other way
    raises.  The outputs (one tensor or a tuple, as ``fn`` returns them)
    come back as DTensors placed as the first argument implies.  With no
    DTensor argument, ``fn(*args)``."""
    if not any(is_dtensor(t) for t in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    in_dims, out_dims = dims
    lead = args[0]
    if not is_dtensor(lead):
        raise ValueError("a local call on DTensors takes a DTensor first "
                         "argument")
    mesh = lead.device_mesh
    coord = mesh.get_coordinate()
    # the first argument's dimension each mesh dimension shards, or None
    split = []
    for p in lead.placements:
        if p.is_replicate():
            split.append(None)
        elif p.is_shard() and p.dim in in_dims[0]:
            split.append(p.dim)
        else:
            raise ValueError(f"a local call's first argument is placed "
                             f"{lead.placements}: only its dimensions "
                             f"{sorted(in_dims[0])} may be sharded")

    def placed(m):
        return [Replicate() if a is None or a not in m else Shard(m[a])
                for a in split]

    shards = []
    for t, m in zip(args, in_dims):
        want = placed(m)
        if is_dtensor(t):
            grad = []
            for i, (p, q) in enumerate(zip(t.placements, want)):
                if p.is_replicate():
                    grad.append(Partial() if split[i] is not None else p)
                elif p == q:
                    grad.append(p)
                else:
                    raise ValueError(
                        f"a local call's argument placed {t.placements} "
                        f"where {want} is needed would be gathered")
            have = t.placements
            t = t.to_local(grad_placements=grad)
        else:
            have = [Replicate()] * len(want)
        for i, (p, q) in enumerate(zip(have, want)):
            if q.is_shard() and p.is_replicate():
                t = t.chunk(mesh.size(i), q.dim)[coord[i]]
        shards.append(t)
    outs = fn(*shards)
    single = torch.is_tensor(outs)
    outs = tuple(DTensor.from_local(o, mesh, placed(m), run_check=False)
                 for o, m in zip((outs,) if single else outs, out_dims))
    return outs[0] if single else outs


def shard_span(x: torch.Tensor, dim: int) -> Tuple[int, int, List[int]]:
    """``(start, length, mesh dims)``: where this rank's shard of the
    DTensor ``x`` lies along tensor dimension ``dim`` (evenly divided,
    the first mesh dimension outermost), and the mesh dimensions that
    shard it; ``(0, size, [])`` for a plain tensor or an unsharded
    dimension."""
    start, length, dims = 0, x.shape[dim], []
    if not is_dtensor(x):
        return start, length, dims
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            length //= mesh.size(i)
            start += coord[i] * length
            dims.append(i)
    return start, length, dims


def unshard(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """A DTensor replicated over the mesh axes ``axes`` (other
    placements kept); any other tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = _mesh_dims(x.device_mesh, axes)
    pl = [Replicate() if i in dims and p.is_shard() else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def reduce(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """``constrain`` a product whose partial sums must be reduced: they
    are summed once, in the product's dtype (the reference's psum of a
    partitioned product), and the sum's gradient is the incoming one on
    every rank (DTensor's own redistribution would hand a partial
    gradient to the product's backward).  A plain tensor, or one with no partial sum, is
    ``constrain``-ed as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    parts = ([p for p in x.placements if p.is_partial()]
             if is_dtensor(x) else [])
    if current_mesh() is None or not parts or any(
            type(p) is not Partial or p.reduce_op != "sum" for p in parts):
        return constrain(x, *axes)
    mesh = x.device_mesh
    dims = tuple(i for i, p in enumerate(x.placements) if p.is_partial())
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    y = SumAcross.apply(x.to_local(grad_placements=pl), mesh, dims)
    y = DTensor.from_local(y, mesh, pl, run_check=False)
    return constrain(y, *axes)


class SumAcross(torch.autograd.Function):
    """A sum all-reduce of local tensors over mesh dimensions whose
    gradient is the incoming one on every rank (each rank's part enters
    the sum once, and the sum's consumers are replicated)."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        out = x.clone()
        for i in dims:
            dist.all_reduce(out, group=mesh.get_group(i))
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None
