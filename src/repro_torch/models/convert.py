"""Parameters of the JAX package's model, carried into the port.

:func:`params_from_numpy` takes the reference's parameter tree with its
leaves as numpy arrays (``groups`` stacked along a leading ``n_groups``
axis, as ``lax.scan`` wants them) and returns the port's parameters
(``groups`` a list, one dictionary per group), so that both packages can
run on the same weights.  The port itself never sees JAX: a caller makes
the numpy tree, e.g. ``jax.tree.map(np.asarray, model.init(key))``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .model import CROSS_ITEM


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


def params_from_numpy(tree: Dict, device="cpu") -> Dict:
    """The port's parameters from the reference's numpy parameter tree,
    on ``device``; values and dtypes unchanged."""
    if "enc_groups" in tree:
        raise NotImplementedError(
            f"the enc-dec encoder is not ported yet: {CROSS_ITEM}")
    out = {k: _tree(v, device) for k, v in tree.items() if k != "groups"}
    stacked = tree["groups"]
    n_groups = len(np.asarray(next(iter(next(iter(
        stacked.values())).values()))))
    out["groups"] = [_tree(_index(stacked, g), device)
                     for g in range(n_groups)]
    return out


def _index(node: Any, g: int):
    if isinstance(node, dict):
        return {k: _index(v, g) for k, v in node.items()}
    return np.asarray(node)[g]
