"""The port's optimisers, schedule, compression and train step against the
JAX reference, on the CPU.

* the reference's optimiser checks (``tests/test_substrate.py``) on the
  port: AdamW and Adafactor descend a quadratic, clipping bounds a huge
  update, error-feedback compression is unbiased over time;
* ``warmup_cosine`` on an int32 step tensor, float32, through warm-up,
  decay and the floor;
* AdamW, Adafactor and compression on the same parameter and gradient
  trees (the reference's parameters of ``smoke`` configs with 4 stacked
  layer groups, plus the enc-dec family's stacked encoder layers and the
  hybrid family's float32 ``a_log``), 3 updates: parameters and state at
  ``rtol = 1e-5, atol = 1e-6``, the step equal; compression's
  dequantized gradients and residual bitwise, so its int8 payload too.
  Adafactor factors each stacked leaf as the reference does (a per-layer
  vector stacked to ``(G, d)`` has ``vr`` of ``(G,)`` and ``vc`` of
  ``(d,)``), and compression scales each stacked leaf by one max: a
  per-group version of either misses these numbers;
* ``make_train_step`` for 3 steps from the reference's parameters on
  ``SyntheticLM`` batches, with and without ``compress=True``: losses at
  ``rtol = 1e-5`` and parameters within ``atol = 1e-4`` (with
  compression, all but the few that an int8 rounding flip moves by at
  most one learning-rate step a step);
  ``make_optimizer`` picks by ``param_count`` as the reference does.

Each reference run is made once per module and shared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as roptim
from repro.configs import base as rbase
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models.model import build_model as rbuild
from repro.train import train_step as rtrain_step
from repro_torch import optim
from repro_torch.configs import base
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import build_model
from repro_torch.optim import compress as tcompress
from repro_torch.optim.tree import leaves
from repro_torch.train import train_step

TOL = dict(rtol=1e-5, atol=1e-6)
#: configs whose groups stack: 4 dense groups; 4 RWKV groups (per-layer
#: vectors and the (4, d) mix); 4 decoder + 2 encoder layers; one Jamba
#: group of 8 sublayers with float32 ``a_log`` (a stack of one)
ARCHS = ("phi4_mini_3_8b", "rwkv6_7b", "whisper_medium",
         "jamba_1_5_large_398b")
STEPS = 3


# ---------------------------------------------------------------------------
# the reference's optimiser checks, on the port
# ---------------------------------------------------------------------------


def _quad_problem():
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8))
                              .astype(np.float32))
    params = {"w": torch.zeros((8, 8))}

    def loss_and_grad(p):
        w = p["w"].detach().requires_grad_(True)
        loss = torch.mean((w - target) ** 2)
        loss.backward()
        return float(loss), {"w": w.grad}

    return params, loss_and_grad


@pytest.mark.parametrize("make", [
    lambda: optim.adamw(1e-1, weight_decay=0.0),
    lambda: optim.adafactor(2e-1),
], ids=["adamw", "adafactor"])
def test_optimizers_descend(make):
    params, loss_and_grad = _quad_problem()
    init, update = make()
    state = init(params)
    l0, _ = loss_and_grad(params)
    for _ in range(60):
        _, grads = loss_and_grad(params)
        params, state = update(grads, state, params)
    assert loss_and_grad(params)[0] < 0.1 * l0
    assert int(state.step) == 60 and state.step.dtype == torch.int32


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros((4,))}
    init, update = optim.adamw(1e-2, clip_norm=1.0, weight_decay=0.0)
    state = init(params)
    huge = {"w": torch.full((4,), 1e9)}
    new_params, _ = update(huge, state, params)
    assert torch.all(new_params["w"].abs() < 1.0)


def test_compression_error_feedback_unbiased():
    g = {"w": torch.from_numpy(np.random.default_rng(1).normal(size=(64,))
                               .astype(np.float32))}
    res = optim.init_residual(g)
    acc = torch.zeros((64,))
    for _ in range(30):
        cg, res = optim.error_feedback_compress(g, res)
        acc = acc + cg["w"]
    # mean compressed gradient converges to the true gradient
    np.testing.assert_allclose((acc / 30).numpy(), g["w"].numpy(),
                               atol=1e-2)


def test_compression_payload_is_int8_at_one_scale_per_stacked_leaf():
    """Every group's dequantized gradient is an int8 payload times the
    one scale of the stacked leaf: max |payload| is 127 over the stack,
    not in each group."""
    grads = {"groups": [{"w": torch.full((3,), 0.5)},
                        {"w": torch.tensor([2.0, -1.0, 0.25])}]}
    deq, _ = optim.error_feedback_compress(grads,
                                           optim.init_residual(grads))
    scale = torch.tensor(2.0) / 127.0
    for d, g in zip(deq["groups"], grads["groups"]):
        q = tcompress.quantize(g["w"], scale)
        assert q.dtype == torch.int8
        assert torch.equal(d["w"], q.float() * scale)
    assert int(tcompress.quantize(grads["groups"][0]["w"], scale)[0]) == 32


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 20, 100),
                                               (3e-4, 200, 10_000),
                                               (1e-2, 0, 5)])
def test_warmup_cosine_matches_reference(peak, warmup, total):
    steps = np.array([0, 1, 2, 7, 19, 20, 21, 57, 99, 100, 150, 9_999],
                     np.int32)
    want = np.asarray(roptim.warmup_cosine(peak, warmup, total)(
        jnp.asarray(steps)))
    got = optim.warmup_cosine(peak, warmup, total)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# optimisers and compression against the reference on stacked groups
# ---------------------------------------------------------------------------


def _trees(arch):
    """The reference's parameters of the smoke config and 3 seeded
    gradient trees of their shapes and dtypes."""
    rcfg = rbase.smoke(rbase.get(arch))
    params = jax.tree.map(np.asarray, jax.jit(rbuild(rcfg).init)(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05)
                          .astype(a.dtype), params) for _ in range(STEPS)]
    return params, grads


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def opt_runs(request):
    """3 updates of each optimiser and of compression, both packages."""
    params, grads = _trees(request.param)
    out = {"arch": request.param, "params": params}
    for kind in ("adamw", "adafactor"):
        r_init, r_update = getattr(roptim, kind)(
            roptim.warmup_cosine(1e-2, 2, 10))
        r_update = jax.jit(r_update)
        t_init, t_update = getattr(optim, kind)(
            optim.warmup_cosine(1e-2, 2, 10))
        rp = jax.tree.map(jnp.asarray, params)
        rs = r_init(rp)
        tp = params_from_numpy(params)
        ts = t_init(tp)
        for g in grads:
            rp, rs = r_update(jax.tree.map(jnp.asarray, g), rs, rp)
            tp, ts = t_update(params_from_numpy(g), ts, tp)
        out[kind] = (_np(rp), _np(rs), tp, ts)
    rr = roptim.init_residual(params)
    tr = optim.init_residual(params_from_numpy(params))
    comp = []
    for g in grads:  # eager: under jit XLA may turn g / scale into a
        # product with 1 / scale, which is not the same rounding
        rd, rr = roptim.error_feedback_compress(
            jax.tree.map(jnp.asarray, g), rr)
        td, tr = optim.error_feedback_compress(params_from_numpy(g), tr)
        comp.append((_np(rd), _np(rr), params_to_numpy(td),
                     params_to_numpy(tr)))
    out["compress"] = comp
    return out


def _assert_tree_close(got, want, **tol):
    wl, wdef = jax.tree_util.tree_flatten_with_path(want)
    assert jax.tree.structure(got) == wdef
    for (path, w), g in zip(wl, jax.tree.leaves(got)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if tol:
            np.testing.assert_allclose(g, w, **tol,
                                       err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_array_equal(g, w,
                                          err_msg=jax.tree_util.keystr(path))


def _torch_np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_params_match_reference(opt_runs, kind):
    rp, _, tp, _ = opt_runs[kind]
    _assert_tree_close(params_to_numpy(tp), rp, **TOL)


def test_adamw_state_matches_reference(opt_runs):
    _, rs, _, ts = opt_runs["adamw"]
    assert int(ts.step) == int(rs.step) == STEPS
    assert ts.step.dtype == torch.int32
    _assert_tree_close(params_to_numpy(ts.m), rs.m, **TOL)
    _assert_tree_close(params_to_numpy(ts.v), rs.v, **TOL)


def test_adafactor_state_matches_reference(opt_runs):
    """``vr`` / ``vc`` in the reference's stacked layout and shapes."""
    _, rs, _, ts = opt_runs["adafactor"]
    assert int(ts.step) == int(rs.step) == STEPS
    _assert_tree_close(_torch_np(ts.vr), rs.vr, **TOL)
    _assert_tree_close(_torch_np(ts.vc), rs.vc, **TOL)


def test_adafactor_factors_stacked_vectors(opt_runs):
    """A per-layer vector of G > 1 groups is a factored (G, d) leaf."""
    _, rs, tp, ts = opt_runs["adafactor"]
    stacked = [leaf for leaf in leaves(tp) if leaf.stacked
               and leaf.parts[0].dim() == 1 and len(leaf.parts) > 1]
    if opt_runs["arch"] == "jamba_1_5_large_398b":
        assert not stacked  # one group: (1, d), factored all the same
        return
    assert stacked
    for leaf in stacked:
        g, d = len(leaf.parts), leaf.parts[0].shape[0]
        node_r, node_c = ts.vr, ts.vc
        for k in leaf.path:
            node_r, node_c = node_r[k], node_c[k]
        assert node_r.shape == (g,) and node_c.shape == (d,)


@pytest.mark.parametrize("step", range(STEPS))
def test_compression_matches_reference_bitwise(opt_runs, step):
    rd, rr, td, tr = opt_runs["compress"][step]
    _assert_tree_close(td, rd)
    _assert_tree_close(tr, rr)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", rbase.ASSIGNED)
def test_make_optimizer_picks_like_reference(arch):
    _, rname = rtrain_step.make_optimizer(rbase.get(arch))
    (init, update), name = train_step.make_optimizer(base.get(arch))
    assert name == rname
    assert name == ("adafactor" if base.param_count(base.get(arch))[0]
                    > 100e9 else "adamw")


TRAIN_ARCHS = ("phi4_mini_3_8b", "kimi_k2_1t_a32b")
#: the trainer's default peak learning rate: at 1e-2 the reference's own
#: jit and eager runs differ by 5.9e-5 after 3 steps (most of PARAM_ATOL),
#: as AdamW normalises gradients near its eps
PEAK_LR = 1e-3
PARAM_ATOL = 1e-4
#: parameters a compressed run may move past PARAM_ATOL by int8 flips
MAX_FLIPPED = 8


@pytest.fixture(scope="module",
                params=[(a, c) for a in TRAIN_ARCHS for c in (False, True)],
                ids=lambda p: f"{p[0]}-{'compress' if p[1] else 'plain'}")
def step_runs(request):
    """3 train steps in both packages from the reference's parameters."""
    arch, compress = request.param
    rcfg, cfg = rbase.smoke(rbase.get(arch)), base.smoke(base.get(arch))
    kw = dict(peak_lr=PEAK_LR, warmup=1, total=10)
    r_init, r_step, r_name = rtrain_step.make_train_step(
        rbuild(rcfg), compress=compress, **kw)
    rstate = r_init(jax.random.PRNGKey(0))
    params = _np(rstate.params)
    t_init, t_step, t_name = train_step.make_train_step(
        build_model(cfg), compress=compress, **kw)
    tstate = t_init(torch.Generator().manual_seed(0), "cpu")
    tstate = tstate._replace(params=params_from_numpy(params))
    data = RSyntheticLM(RDataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=4))
    r_fn = jax.jit(r_step)
    rl, tl = [], []
    for i in range(STEPS):
        b = data.batch_at(i)
        rstate, rm = r_fn(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = t_step(tstate, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        assert int(tm["step"]) == i
        rl.append(float(rm["loss"]))
        tl.append(float(tm["loss"]))
    return dict(names=(r_name, t_name), rstate=rstate, tstate=tstate,
                rl=rl, tl=tl, compress=compress)


def test_train_step_matches_reference(step_runs):
    r_name, t_name = step_runs["names"]
    assert r_name == t_name == "adamw"
    np.testing.assert_allclose(step_runs["tl"], step_runs["rl"], rtol=1e-5)
    rs, ts = step_runs["rstate"], step_runs["tstate"]
    assert int(ts.step) == int(rs.step) == STEPS
    got, want = params_to_numpy(ts.params), _np(rs.params)
    if not step_runs["compress"]:
        assert ts.residual is None and rs.residual is None
        _assert_tree_close(got, want, atol=PARAM_ATOL, rtol=0)
        _assert_tree_close(params_to_numpy(ts.opt.m), _np(rs.opt.m),
                           atol=PARAM_ATOL, rtol=0)
        return
    # int8 compression is discontinuous: the two packages' float32
    # gradients agree to rounding, and an element that sits that close to
    # a rounding boundary takes the other int8 value (one quantum; 1-2 of
    # ~2e5 elements a step here).  AdamW's normalisation turns one quantum
    # into up to one learning-rate step, so those few elements are held
    # to what a flip can do, every other one to PARAM_ATOL.  Compression
    # itself is held bitwise on equal gradients above.
    off = 0
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        diff = np.abs(g - w)
        off += int((diff > PARAM_ATOL).sum())
        assert diff.max() <= STEPS * PEAK_LR
    assert off <= MAX_FLIPPED
