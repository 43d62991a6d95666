"""The port's training objective and its gradients against the JAX
reference, on the CPU.

* ``Model.loss`` and every gradient leaf, for the ``smoke`` config of all
  ten architectures (float32, on the reference's own parameters through
  ``params_from_numpy``, gradients restacked by ``params_to_numpy``):
  loss at ``rtol = 1e-5``, gradients at ``rtol = 1e-4, atol = 1e-6``;
  the MoE families' router gradient among them, also under
  ``dispatch="dense"`` and at a capacity that poisons;
* the reference's ``test_train_step_smoke`` on the port: a finite loss
  near ``log(vocab)`` and finite gradients for every config;
* the remat: each layer group (and encoder layer) runs under
  ``torch.utils.checkpoint``, so the backward recomputes it;
* the kernels under a gradient: ``jax.grad`` through each of the
  reference's five Pallas kernels fails (``NotImplementedError`` for the
  gather, the scatter and paged attention; an ``AssertionError`` inside
  ``pallas_call``'s JVP rule for the grouped GEMM and flash attention),
  and each of the port's five kernel entries, and its ``ops`` wrapper,
  raises ``NotImplementedError`` when autograd records and an input
  requires a gradient; so does a loss through ``dispatch="spec-kernel"``
  in both packages.  Without a gradient the entries run as before.

Each reference run is made once per module and shared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.kernels.flash_attention import flash_attention as rflash
from repro.kernels.paged_attention import paged_attention as rpaged
from repro.kernels.ragged_matmul import ragged_matmul as rragged
from repro.kernels.spec_gather import spec_gather as rgather
from repro.kernels.spec_scatter import spec_scatter_add as rscatter
from repro.models.model import build_model as rbuild
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ragged_matmul import ragged_matmul
from repro_torch.kernels.spec_gather import spec_gather
from repro_torch.kernels.spec_scatter import spec_scatter_add
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import build_model
from repro_torch.train.train_step import value_and_grad

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, T = 2, 16

#: (case id, arch, dispatch, capacity factor or None for the config's)
CASES = [(name, name, "spec", None) for name in rbase.ASSIGNED] + [
    ("kimi_k2_1t_a32b-dense", "kimi_k2_1t_a32b", "dense", None),
    ("kimi_k2_1t_a32b-poison", "kimi_k2_1t_a32b", "spec", 0.5),
]


def _cfgs(arch, cf=None):
    rcfg, cfg = rbase.smoke(rbase.get(arch)), base.smoke(base.get(arch))
    if cf is not None:
        rcfg = dataclasses.replace(rcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return rcfg, cfg


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def loss_run(request):
    """The reference's loss and gradients on its own parameters, and the
    port's on the same parameters and batch."""
    _, arch, dispatch, cf = request.param
    rcfg, cfg = _cfgs(arch, cf)
    rm = rbuild(rcfg, dispatch)
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(rm.loss))(params, batch)
    model = build_model(cfg, dispatch)
    tparams = params_from_numpy(params)
    loss, grads = value_and_grad(model, tparams, _torch_batch(batch))
    return dict(cfg=cfg, model=model, params=tparams, batch=batch,
                rloss=float(rloss), rgrads=jax.tree.map(np.asarray, rgrads),
                loss=loss, grads=grads)


def test_loss_matches_reference(loss_run):
    assert loss_run["loss"].dtype == torch.float32
    assert loss_run["loss"].shape == ()
    np.testing.assert_allclose(float(loss_run["loss"]), loss_run["rloss"],
                               rtol=LOSS_RTOL)


def test_grads_match_reference(loss_run):
    want = jax.tree_util.tree_flatten_with_path(loss_run["rgrads"])
    got = params_to_numpy(loss_run["grads"])
    assert jax.tree.structure(got) == want[1]
    for (path, w), g in zip(want[0], jax.tree.leaves(got)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_allclose(g, w, **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the gate's gradient flows through the router's stable sort and the
    # speculative dispatch into every MoE sublayer's router
    routers = [p["router"] for g in loss_run["grads"]["groups"]
               for k, p in g.items() if k.endswith("_moe")]
    assert bool(routers) == bool(loss_run["cfg"].n_experts)
    assert all(r.abs().max() > 0 for r in routers)


def test_poison_case_poisons():
    """The poisoning case does poison: the backward runs through dropped
    requests."""
    _, cfg = _cfgs("kimi_k2_1t_a32b", 0.5)
    model = build_model(cfg, "spec")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tok = _torch_batch(_batch(cfg))["tokens"].long()
    with torch.no_grad():
        _, _, _, poison = model._run_groups(params, params["embed"][tok],
                                            collect_stats=True)
    assert int(poison) > 0


def test_train_step_smoke(loss_run):
    """The reference's per-architecture train-grad smoke on the port."""
    cfg, loss = loss_run["cfg"], float(loss_run["loss"])
    assert np.isfinite(loss)
    for g in jax.tree.leaves(params_to_numpy(loss_run["grads"])):
        assert np.all(np.isfinite(g))
    assert 0.5 * np.log(cfg.vocab) < loss < 2.5 * np.log(cfg.vocab)


def test_parameters_stay_plain_after_the_step(loss_run):
    """The step marks the parameters as requiring a gradient only while
    it runs."""
    for p in jax.tree.leaves(loss_run["params"]):
        assert not p.requires_grad


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "whisper_medium"])
def test_groups_are_rematerialised(arch, monkeypatch):
    """Each group (and encoder layer) runs once in the forward and once
    more in the backward (non-reentrant checkpoint)."""
    cfg = base.smoke(base.get(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    calls = []
    for name in ("_run_groups", "_enc_layer"):
        orig = getattr(tmodel.Model, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(tmodel.Model, name, counted)
    value_and_grad(model, params, _torch_batch(_batch(cfg)))
    assert calls.count("_run_groups") == 2 * tmodel.group_count(cfg)
    assert calls.count("_enc_layer") == 2 * cfg.n_enc_layers


# ---------------------------------------------------------------------------
# kernels under a gradient
# ---------------------------------------------------------------------------


def _kernel_inputs():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "spec_gather": ((f(16, 8), np.array([0, 3, -1, 5], np.int32)),
                        (0,)),
        "spec_scatter_add": ((f(16, 8), np.array([0, 3, -1, 3], np.int32),
                              f(4, 8)), (0, 2)),
        "ragged_matmul": ((f(16, 32), f(2, 32, 16)), (0, 1)),
        "flash_attention": ((f(1, 2, 16, 64), f(1, 2, 16, 64),
                             f(1, 2, 16, 64)), (0, 1, 2)),
        "paged_attention": ((f(2, 2, 64), f(4, 8, 2, 64), f(4, 8, 2, 64),
                             np.array([[0, 1], [2, 3]], np.int32),
                             np.array([10, 5], np.int32)), (0, 1, 2)),
    }


REFERENCE = {
    "spec_gather": (rgather, NotImplementedError),
    "spec_scatter_add": (rscatter, NotImplementedError),
    "ragged_matmul": (lambda x, w: rragged(x, w, capacity=8),
                      AssertionError),
    "flash_attention": (rflash, AssertionError),
    "paged_attention": (rpaged, NotImplementedError),
}
PORT = {
    "spec_gather": (spec_gather, ops.spec_gather),
    "spec_scatter_add": (spec_scatter_add, ops.spec_scatter_add),
    "ragged_matmul": (lambda x, w: ragged_matmul(x, w, capacity=8),
                      lambda x, w: ops.ragged_matmul(x, w, 8)),
    "flash_attention": (flash_attention, ops.flash_attention),
    "paged_attention": (paged_attention, ops.paged_attention),
}


@pytest.mark.parametrize("name", list(REFERENCE))
def test_reference_kernel_has_no_gradient(name):
    args, diff = _kernel_inputs()[name]
    fn, err = REFERENCE[name]
    for i in diff:
        def f(x, i=i):
            a = list(args)
            a[i] = x
            return fn(*a).sum()
        with pytest.raises(err):
            jax.grad(f)(jnp.asarray(args[i]))


@pytest.mark.parametrize("entry", ["kernel", "ops"])
@pytest.mark.parametrize("name", list(PORT))
def test_kernel_refuses_a_gradient(name, entry):
    args, diff = _kernel_inputs()[name]
    fn = PORT[name][entry == "ops"]
    for i in diff:
        a = [torch.from_numpy(x.copy()) for x in args]
        a[i].requires_grad_(True)
        with pytest.raises(NotImplementedError, match="no backward"):
            fn(*a)
        with torch.no_grad():  # autograd not recording: the kernel runs
            fn(*a)
    fn(*[torch.from_numpy(x.copy()) for x in args])


def test_spec_kernel_loss_refuses_a_gradient_like_the_reference():
    rcfg, cfg = _cfgs("kimi_k2_1t_a32b")
    rm = rbuild(rcfg, "spec-kernel")
    params = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    with pytest.raises(NotImplementedError):
        jax.grad(rm.loss)(params, batch)
    model = build_model(cfg, "spec-kernel")
    with pytest.raises(NotImplementedError, match="no backward"):
        value_and_grad(model, params_from_numpy(params), _torch_batch(batch))
    # without a gradient the same dispatch serves as before
    with torch.no_grad():
        loss = model.loss(params_from_numpy(params), _torch_batch(batch))
    assert torch.isfinite(loss)
