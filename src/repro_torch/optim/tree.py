"""Parameter trees as the reference's optimisers see them.

The port keeps each layer group's parameters in a list, one dictionary a
group (``params["groups"][g]``, ``params["enc_groups"][i]``).  The
reference stacks the same-named parameters of every group along a
leading axis, and its optimisers see each stacked array as one leaf.
That matters wherever a leaf is more than its elements: Adafactor
factors every leaf of two or more dimensions (so a per-layer vector,
stacked to ``(G, d)``, is factored across the groups) and clips each
leaf's update by its RMS, compression scales each leaf by its max, and
AdamW's global norm sums over all of them.  :func:`leaves` gives those
leaves over the port's tree, without copying: a :class:`Leaf` holds the
tensor, or the same-named tensors of every group.
"""
from __future__ import annotations

from functools import reduce
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class Leaf(NamedTuple):
    """One leaf of the reference's tree: its key path, its tensor
    (``stacked`` False) or the same-named tensors of every group, in
    group order (``stacked`` True, the reference's leading axis)."""

    path: Tuple[str, ...]
    parts: List[torch.Tensor]
    stacked: bool

    @property
    def shape(self) -> Tuple[int, ...]:
        """The shape of the reference's (stacked) leaf."""
        head = (len(self.parts),) if self.stacked else ()
        return head + tuple(self.parts[0].shape)


def map_parts(fn: Callable[[Tuple[str, ...], Optional[int], torch.Tensor],
                           Any], tree: Any, path: Tuple[str, ...] = (),
              group: Optional[int] = None) -> Any:
    """A tree of the port's layout with ``fn(path, group, tensor)`` at each
    tensor; ``group`` is the index in the enclosing list, or None.  Keys
    are visited in sorted order, as ``jax.tree`` flattens a dictionary,
    so two trees with the same keys are visited alike whatever order
    their dictionaries were built in."""
    if isinstance(tree, dict):
        return {k: map_parts(fn, tree[k], path + (k,), group)
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_parts(fn, v, path, g) for g, v in enumerate(tree)]
    return fn(path, group, tree)


def leaves(tree: Any) -> List[Leaf]:
    """The reference's leaves of a tree in the port's layout, in
    :func:`map_parts`' order: each tensor outside a list alone, the tensors of a list
    of dictionaries gathered by key path."""
    out: Dict[Tuple[str, ...], Leaf] = {}

    def add(path, group, t):
        out.setdefault(path, Leaf(path, [], group is not None)
                       ).parts.append(t)

    map_parts(add, tree)
    return list(out.values())


def stacked_tree(ls: List[Leaf], fn: Callable[[Leaf], Any]) -> Dict:
    """A tree in the reference's layout (nested dictionaries, groups
    stacked) with ``fn(leaf)`` at each leaf."""
    out: Dict = {}
    for leaf in ls:
        node = out
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = fn(leaf)
    return out


def at(tree: Dict, path: Tuple[str, ...]) -> Any:
    """The node of ``tree`` at ``path``."""
    return reduce(lambda node, k: node[k], path, tree)


def stack_f32(leaf: Leaf) -> torch.Tensor:
    """The reference's leaf as one new float32 tensor (one copy).  Parts
    that are DTensors (a mesh) stack into a DTensor sharded as they are,
    its group axis replicated, so no rank gathers a gradient."""
    if hasattr(leaf.parts[0], "placements"):
        if not leaf.stacked:
            return leaf.parts[0].float().clone()
        return torch.stack([t.float() for t in leaf.parts])
    out = torch.empty(leaf.shape, dtype=torch.float32,
                      device=leaf.parts[0].device)
    if not leaf.stacked:
        return out.copy_(leaf.parts[0])
    for g, t in enumerate(leaf.parts):
        out[g].copy_(t)
    return out
