"""Parameters of the JAX package's model, carried into the port.

:func:`params_from_numpy` takes the reference's parameter tree with its
leaves as numpy arrays (``groups`` stacked along a leading ``n_groups``
axis and the enc-dec family's ``enc_groups`` along ``n_enc_layers``, as
``lax.scan`` wants them) and returns the port's parameters (each a list,
one dictionary per group or layer), so that both packages can
run on the same weights.  The port itself never sees JAX: a caller makes
the numpy tree, e.g. ``jax.tree.map(np.asarray, model.init(key))``.
Any tree of the parameters' shape crosses the same way (gradients, a
gradient-shaped state).  :func:`params_to_numpy` is the inverse: it
restacks ``groups`` and ``enc_groups`` so that the port's parameters,
gradients or AdamW moments can be held to the reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(node: Any, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    return _tensor(np.asarray(node), device)


#: the subtrees stacked along a leading axis
_STACKED = ("groups", "enc_groups")


def params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """The port's parameters from the reference's numpy parameter tree,
    on ``device``; values and dtypes unchanged (a float32 leaf in a bf16
    tree, Mamba's ``a_log``, stays float32)."""
    out = {}
    for k, v in tree.items():
        if k in _STACKED:
            n = len(np.asarray(next(iter(next(iter(v.values())).values()))))
            out[k] = [_tree(_index(v, g), device) for g in range(n)]
        else:
            out[k] = _tree(v, device)
    return out


def _index(node: Any, g: int):
    if isinstance(node, dict):
        return {k: _index(v, g) for k, v in node.items()}
    return np.asarray(node)[g]


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)  # no view of a live tensor
    if t.dtype == torch.bfloat16:  # same bits as ml_dtypes' bfloat16
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _numpy_tree(node: Any):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    return _numpy(node)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def params_to_numpy(params: Dict) -> Dict:
    """The reference's numpy tree from the port's parameters (or any tree
    of their shape): ``groups`` and ``enc_groups`` stacked along a leading
    axis, values and dtypes unchanged (bfloat16 as ``ml_dtypes``')."""
    return {k: _stack([_numpy_tree(g) for g in v]) if k in _STACKED
            else _numpy_tree(v) for k, v in params.items()}
