"""The training step: loss → grads → optimizer, with optional
error-feedback gradient compression ahead of the DP all-reduce
(counterpart of the JAX package's ``train/train_step.py``).

Where the reference takes ``jax.value_and_grad(model.loss)``, the step
marks the parameters as requiring a gradient for the forward and
backward passes only, takes ``torch.autograd.grad`` of the loss, and
clears the mark again, so the parameters stay plain tensors between
steps (the serving paths and the checkpoint see no autograd state).  The
optimizer then writes the new parameters into the old ones.  Profiler
ranges name the parts of a step: ``train.forward``, ``train.backward``
(with the checkpointed groups' recompute) and ``train.optimizer`` (with
the compression).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from .. import optim as optim_mod
from ..configs.base import ArchConfig, param_count
from ..models.model import Model
from ..optim.adafactor import AdafactorState
from ..optim.adamw import AdamWState
from ..optim.tree import map_parts


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor
    residual: Any = None     # error-feedback compression state


#: each optimizer's state type, by the name :func:`make_optimizer` gives
OPT_STATES = {"adamw": AdamWState, "adafactor": AdafactorState}


def make_optimizer(cfg: ArchConfig, *, peak_lr: float = 3e-4,
                   warmup: int = 200, total: int = 10_000):
    """AdamW below ~100B params; Adafactor above (O(r+c) optimizer
    state — the 1T-param memory play)."""
    lr = optim_mod.warmup_cosine(peak_lr, warmup, total)
    total_params, _ = param_count(cfg)
    if total_params > 100e9:
        return optim_mod.adafactor(lr), "adafactor"
    return optim_mod.adamw(lr), "adamw"


def value_and_grad(model: Model, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict]:
    """The loss (detached) and its gradient with respect to every
    parameter, in the parameters' layout and dtypes (a parameter the loss
    does not reach gets zeros, as ``jax.grad`` gives).  On a mesh each
    gradient takes its parameter's placements (the reference's state
    shardings), its partial sums over the data axes reduced there."""
    flat = []
    map_parts(lambda path, group, p: flat.append(p), params)
    try:
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            with record_function("train.forward"):
                loss = model.loss(params, batch)
            with record_function("train.backward"):
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else _placed_like(g, p)
              for p, g in zip(flat, grads))
    return loss.detach(), map_parts(lambda path, group, p: next(it), params)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` with the placements of the parameter ``p`` (a DTensor's
    gradient may come out partial, or sharded otherwise); a plain tensor
    as it is."""
    if not hasattr(g, "placements"):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(model: Model, *, compress: bool = False,
                    opt_cfg: Optional[ArchConfig] = None, **opt_kw):
    """``(init_state, train_step, opt_name)``.  ``opt_cfg`` is the config
    whose parameter count picks the optimizer (the model's by default;
    a model cut in depth passes its whole config, to train with the
    optimizer the whole model would take)."""
    (opt_init, opt_update), opt_name = make_optimizer(
        opt_cfg or model.cfg, **opt_kw)

    def init_state(generator: torch.Generator, device=None) -> TrainState:
        params = model.init(generator, device)
        res = optim_mod.init_residual(params) if compress else None
        opt = opt_init(params)
        return TrainState(params, opt,
                          torch.zeros((), dtype=torch.int32,
                                      device=opt.step.device), res)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        loss, grads = value_and_grad(model, state.params, batch)
        residual = state.residual
        with record_function("train.optimizer"):
            if compress:
                grads, residual = optim_mod.error_feedback_compress(
                    grads, residual)
            new_params, new_opt = opt_update(grads, state.opt, state.params)
        metrics = {"loss": loss, "step": state.step}
        return TrainState(new_params, new_opt, state.step + 1,
                          residual), metrics

    return init_state, train_step, opt_name


def state_from_tree(tree: Dict, opt_name: str) -> TrainState:
    """A :class:`TrainState` from the plain tree a checkpoint holds."""
    return TrainState(tree["params"], OPT_STATES[opt_name](**tree["opt"]),
                      tree["step"], tree["residual"])
