"""Kimi-K2 at its published head width on the CPU against the JAX
reference, and the configs of ``chip_smoke.py``'s full-width training
phases.

* ``Model.loss`` and every gradient leaf of Kimi-K2's smoke config with
  ``head_dim=112`` (the published 7168 / 64, the tile route's d 112 on the
  card), built the same way in both packages, on the reference's own
  parameters carried across with ``params_from_numpy``: the loss at
  ``LOSS_RTOL`` and the gradients at ``GRAD_TOL``, the tolerances of
  ``tests/test_torch_loss.py``; with the config's capacity and at one
  that poisons.
* ``[train-kimi]`` and ``[train-jamba]``'s configs equal the published
  ones in every field but ``n_layers`` and ``n_experts``, and
  ``make_optimizer`` picks Adafactor for the whole configs (the phases
  pass them as ``opt_cfg``: the cut configs alone would pick AdamW).

The reference's run is made once per case and shared.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import base as rbase
from repro.models.model import build_model as rbuild
from repro_torch.configs import base
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import build_model
from repro_torch.train.train_step import make_optimizer, value_and_grad

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, T = 2, 16
ARCH = "kimi_k2_1t_a32b"
#: Kimi-K2's head width (d_model 7168 over 64 heads)
HEAD_DIM = 112
#: (case id, capacity factor or None for the config's)
CASES = [("capacity", None), ("poison", 0.5)]


def _cfgs(cf):
    extra = dict(head_dim=HEAD_DIM)
    if cf is not None:
        extra["capacity_factor"] = cf
    return (dataclasses.replace(rbase.smoke(rbase.get(ARCH)), **extra),
            dataclasses.replace(base.smoke(base.get(ARCH)), **extra))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def wide_run(request):
    """The reference's loss and gradients on its own parameters, and the
    port's on the same parameters and batch."""
    rcfg, cfg = _cfgs(request.param[1])
    assert cfg.hd == rcfg.hd == HEAD_DIM
    rm = rbuild(rcfg, "spec")
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    rloss, rgrads = jax.jit(jax.value_and_grad(rm.loss))(params, batch)
    model = build_model(cfg, "spec")
    tparams = params_from_numpy(params)
    loss, grads = value_and_grad(
        model, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(cfg=cfg, model=model, params=tparams, batch=batch,
                rloss=float(rloss), rgrads=jax.tree.map(np.asarray, rgrads),
                loss=loss, grads=grads)


def test_wide_head_loss_matches_reference(wide_run):
    assert wide_run["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(wide_run["loss"]), wide_run["rloss"],
                               rtol=LOSS_RTOL)


def test_wide_head_grads_match_reference(wide_run):
    want = jax.tree_util.tree_flatten_with_path(wide_run["rgrads"])
    got = params_to_numpy(wide_run["grads"])
    assert jax.tree.structure(got) == want[1]
    for (path, w), g in zip(want[0], jax.tree.leaves(got)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_allclose(g, w, **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the attention projections are 112 columns a head
    attn = wide_run["grads"]["groups"][0]["s0_attn"]
    assert any(t.shape[-1] == wide_run["cfg"].n_heads * HEAD_DIM
               for t in attn.values())


def test_wide_head_poison_case_poisons():
    """The poisoning case does poison at the wide head."""
    _, cfg = _cfgs(0.5)
    model = build_model(cfg, "spec")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T))).long()
    with torch.no_grad():
        _, _, _, poison = model._run_groups(params, params["embed"][tok],
                                            collect_stats=True)
    assert int(poison) > 0


@pytest.mark.parametrize("arch,cut", [
    ("kimi_k2_1t_a32b", chip_smoke.TRAIN_KIMI),
    ("jamba_1_5_large_398b", chip_smoke.TRAIN_JAMBA)])
def test_full_width_train_cuts(arch, cut):
    """The phases' configs are the published ones but for the layers and
    experts kept; the whole configs pick Adafactor, the cut ones would
    not."""
    full, cfg = chip_smoke.train_cut(arch, cut)
    assert full == base.get(arch)
    changed = {f.name for f in dataclasses.fields(full)
               if getattr(full, f.name) != getattr(cfg, f.name)}
    assert changed == {"n_layers", "n_experts"}
    assert (cfg.n_layers, cfg.n_experts) == (cut["n_layers"],
                                             cut["n_experts"])
    assert 1 <= cfg.n_layers < full.n_layers
    assert cfg.top_k < cfg.n_experts < full.n_experts
    # the published widths, which the kernels' routes depend on
    assert (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads) == (
        full.d_model, full.hd, full.n_heads, full.n_kv_heads)
    assert make_optimizer(full)[1] == "adafactor"
    assert make_optimizer(cfg)[1] == "adamw"


def test_full_width_train_shapes():
    """The steps' shapes: [train-kimi] at TRAIN's 8 x 256 tokens and d
    112; [train-jamba] at 2 x 1024, d 128, one group of 7 Mamba and 1
    attention layers with MoE on every second."""
    from repro_torch.models.model import group_pattern
    _, kimi = chip_smoke.train_cut(ARCH, chip_smoke.TRAIN_KIMI)
    assert kimi.hd == 112 and group_pattern(kimi) == ("attn", "moe")
    assert (chip_smoke.TRAIN["batch"], chip_smoke.TRAIN["seq_len"]) == (8,
                                                                       256)
    _, jamba = chip_smoke.train_cut("jamba_1_5_large_398b",
                                    chip_smoke.TRAIN_JAMBA)
    pattern = group_pattern(jamba)
    assert jamba.hd == 128 and jamba.n_layers == jamba.attn_stride
    assert pattern.count("mamba") == 7 and pattern.count("attn") == 1
    assert pattern.count("moe") == 4 and pattern.count("mlp") == 4
    assert (chip_smoke.TRAIN_JAMBA["batch"],
            chip_smoke.TRAIN_JAMBA["seq_len"]) == (2, 1024)
