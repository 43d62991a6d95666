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
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Sequence, Tuple, Union

import torch

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
    to None); any other tensor, or no mesh, passes through."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    spec = resolve_spec(x.shape, axes, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
