"""The ssm and hybrid families of the port (RWKV-6, Mamba/Jamba) against
the JAX reference, on the CPU.

* blocks: ``rwkv6_block`` and ``mamba_block`` on seeded inputs, float32 at
  ``atol = rtol = 1e-4`` and bfloat16 at ``BF16_TOL`` (the two packages'
  bf16 matmuls and sigmoid/silu round differently); the scans' casts
  bitwise in bf16 on inputs whose projections and decay both packages
  compute exactly; prefill of T tokens then one decode step equals T + 1;
* the model (``smoke`` configs of ``rwkv6_7b``, also with fewer
  ``n_heads`` than RWKV's ``d_model / head_dim`` heads, and of
  ``jamba_1_5_large_398b`` at a capacity that poisons): prefill and
  decode logits, KV caches and SSM states at ``1e-4`` and poison counts
  equal, on the reference's own parameters; ``spec-kernel`` bitwise
  ``spec`` in the port;
* the engine: committed tokens and per-wave stats equal to the reference
  ``Engine``'s over two left-padded waves (pads flow into the SSM states
  in both packages: a batched request is not its solo run);
* ``params_from_numpy`` bit for bit, the float32 ``a_log`` inside a bf16
  tree included; the serve launcher on the CPU.

The reference's Jamba runs take ``dispatch="spec"`` (its ``spec-kernel``
goes through Pallas interpret mode); each reference run is made once per
module and shared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import ssm as rssm
from repro.models.model import build_model as rbuild
from repro.serve.engine import Engine as REngine
from repro.serve.engine import Request as RRequest
from repro_torch.configs import base
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, Request

TOL = dict(atol=1e-4, rtol=1e-4)
#: bfloat16 blocks: rtol, and atol as a share of max|want|
BF16_TOL = 2e-2
B, T, D, HD, N = 2, 9, 64, 16, 16
PADS = np.array([0, 3, 5], np.int32)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    """numpy (float32, int32 or ml_dtypes bf16) -> the same torch bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


def _bf16_close(got, want):
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=BF16_TOL,
        atol=BF16_TOL * float(np.abs(want).max()))


def _cast(params, dtype):
    """One parameter dict for both packages: (torch, jax), ``a_log``
    kept float32 as the model keeps it."""
    out = {k: v if k == "a_log" or dtype == "float32"
           else v.astype(ml_dtypes.bfloat16) for k, v in params.items()}
    return ({k: _t(v) for k, v in out.items()},
            {k: jnp.asarray(v) for k, v in out.items()})


def _rwkv_params(rng):
    return {"mu": rng.random((4, D)).astype(np.float32),
            "wr": _randn(rng, D, D, scale=0.1),
            "wk": _randn(rng, D, D, scale=0.1),
            "wv": _randn(rng, D, D, scale=0.1),
            "ww": _randn(rng, D, D, scale=0.05),
            "w_bias": _randn(rng, D, scale=0.5) + 2.0,
            "u": _randn(rng, D, scale=0.5),
            "wo": _randn(rng, D, D, scale=0.1)}


def _mamba_params(rng):
    return {"in_proj": _randn(rng, D, D, scale=0.1),
            "gate_proj": _randn(rng, D, D, scale=0.1),
            "dt_proj": _randn(rng, D, scale=0.1),
            "b_proj": _randn(rng, D, N, scale=0.1),
            "c_proj": _randn(rng, D, N, scale=0.1),
            "a_log": _randn(rng, D, N, scale=0.5),
            "out_proj": _randn(rng, D, D, scale=0.1)}


def _rwkv(params, x, state, pkg):
    block = ssm.rwkv6_block if pkg == "torch" else rssm.rwkv6_block
    return block(params, x, n_heads=D // HD, head_dim=HD, state=state,
                 return_state=state is not None)


def _mamba(params, x, state, pkg):
    block = ssm.mamba_block if pkg == "torch" else rssm.mamba_block
    return block(params, x, d_state=N, state=state,
                 return_state=state is not None)


def _states(kind, rng):
    """A seeded non-zero state for both packages: (torch, jax)."""
    if kind == "rwkv":
        s = _randn(rng, B, D // HD, HD, HD, scale=0.1)
        last = _randn(rng, B, D)
        return (_t(s), _t(last)), (jnp.asarray(s), jnp.asarray(last))
    s = _randn(rng, B, D, N, scale=0.1)
    return _t(s), jnp.asarray(s)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_block_matches_reference(kind, dtype, with_state):
    rng = _rng(1)
    raw = _rwkv_params(rng) if kind == "rwkv" else _mamba_params(rng)
    tp, jp = _cast(raw, dtype)
    x = _randn(rng, B, T, D)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    ts, js = _states(kind, rng) if with_state else (None, None)
    block = _rwkv if kind == "rwkv" else _mamba
    got = block(tp, _t(x), ts, "torch")
    want = block(jp, jnp.asarray(x), js, "jax")
    got_leaves, want_leaves = (jax.tree.leaves(got), jax.tree.leaves(want))
    assert len(got_leaves) == len(want_leaves) == (
        1 if not with_state else 3 if kind == "rwkv" else 2)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == getattr(torch, np.asarray(w).dtype.name)
        if dtype == "float32":
            _close(g, w)
        else:
            _bf16_close(g, w)


def _exact_inputs(rng, kind, dtype=ml_dtypes.bfloat16):
    """Inputs both packages project exactly: permutation matrices, mixes
    of 1, and a constant pre-activation where the two packages' bf16
    sigmoid, softplus and silu agree; what differs is the scan alone."""
    eye = np.eye(D, dtype=np.float32)
    perm = lambda seed, n=D: eye[_rng(seed).permutation(D)][:, :n]
    x = _randn(rng, B, T, D, scale=2.0)
    if kind == "rwkv":
        # ww = 0, w_bias = 0: the decay is sigmoid(0) = 0.5 in both
        p = {"mu": np.ones((4, D), np.float32), "wr": perm(1),
             "wk": perm(2), "wv": perm(3), "ww": np.zeros((D, D), np.float32),
             "w_bias": np.zeros(D, np.float32), "u": _randn(rng, D),
             "wo": perm(5)}
    else:
        # a constant column of x makes delta = softplus(0.5) and the gate
        # silu(1), both bitwise alike; a_log = 0 as the model initialises
        x[..., 0] = 1.0
        gate = np.zeros((D, D), np.float32)
        gate[0] = 1.0
        dtp = np.zeros(D, np.float32)
        dtp[0] = 0.5
        p = {"in_proj": perm(1), "gate_proj": gate, "dt_proj": dtp,
             "b_proj": perm(2, N), "c_proj": perm(3, N),
             "a_log": np.zeros((D, N), np.float32), "out_proj": perm(4)}
    return p, x.astype(dtype)


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_scan_casts_match_reference_bitwise(kind):
    """bf16: the RWKV outer product k·v rounded to bf16 before it joins
    the float32 state, the state plus u·kv cast to r's dtype for the
    read-out; Mamba's float32 exp(Δ·A) and its unrounded Δ·u·B.  On exact
    projections the outputs are bitwise the reference's, and so is the
    RWKV state (Mamba's differs only by float32 exp's last bit)."""
    p, x = _exact_inputs(_rng(2), kind)
    tp, jp = _cast(p, "bfloat16")
    block = _rwkv if kind == "rwkv" else _mamba
    if kind == "rwkv":
        zero = ((torch.zeros(B, D // HD, HD, HD), torch.zeros(B, D)),
                (jnp.zeros((B, D // HD, HD, HD)), jnp.zeros((B, D))))
    else:
        zero = (torch.zeros(B, D, N), jnp.zeros((B, D, N)))
    got, gstate = block(tp, _t(x), zero[0], "torch")
    want, wstate = block(jp, jnp.asarray(x), zero[1], "jax")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    gs, ws = jax.tree.leaves(gstate)[0], jax.tree.leaves(wstate)[0]
    assert gs.dtype == torch.float32
    if kind == "rwkv":
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    else:
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_block_prefill_then_decode_equals_longer_prefill(kind):
    """T tokens with a zero state, then one more token with the returned
    state: the outputs and final state of T + 1 tokens at once."""
    rng = _rng(3)
    raw = _rwkv_params(rng) if kind == "rwkv" else _mamba_params(rng)
    tp = {k: _t(v) for k, v in raw.items()}
    x = _t(_randn(rng, B, T + 1, D))
    zero, _ = _states(kind, _rng(0))
    zero = jax.tree.map(torch.zeros_like, zero)
    block = _rwkv if kind == "rwkv" else _mamba
    y_all, s_all = block(tp, x, zero, "torch")
    y_pre, s_pre = block(tp, x[:, :T], zero, "torch")
    y_one, s_one = block(tp, x[:, T:], s_pre, "torch")
    torch.testing.assert_close(torch.cat([y_pre, y_one], 1), y_all,
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(s_one), jax.tree.leaves(s_all)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

#: (arch, config changes): RWKV with n_heads != d_model / head_dim, as
#: RWKV-6-7B has (32 against 64); Jamba at a capacity that poisons
MODELS = {"rwkv6_7b": {}, "rwkv6_7b-heads": {"n_heads": 2},
          "jamba_1_5_large_398b": {"capacity_factor": 0.5}}


def _cfgs(case):
    arch = case.split("-")[0]
    return (dataclasses.replace(rbase.smoke(rbase.get(arch)), **MODELS[case]),
            dataclasses.replace(base.smoke(base.get(arch)), **MODELS[case]))


def _tokens(cfg, seed=1, t=9):
    return _rng(seed).integers(1, cfg.vocab, (3, t)).astype(np.int32)


def _port_states(states):
    """The port's states (a list over groups) stacked over groups like
    the reference's, as a flat list of leaves in its order."""
    out = []
    for i, s in enumerate(states[0]):
        parts = s if isinstance(s, tuple) else (s,)
        for j in range(len(parts)):
            out.append(torch.stack([
                (g[i] if isinstance(g[i], tuple) else (g[i],))[j]
                for g in states]))
    return out


def _port_caches(caches):
    return [torch.stack([g[a][j] for g in caches])
            for a in range(len(caches[0])) for j in range(2)]


@pytest.fixture(scope="module", params=list(MODELS))
def model_reference(request):
    """Reference parameters, prefill (left-padded) and one decode step,
    with poison stats, caches and states."""
    rcfg, _ = _cfgs(request.param)
    m = rbuild(rcfg, "spec")
    params = m.init(jax.random.PRNGKey(0))
    tok = _tokens(rcfg)
    logits, cache, st = m.prefill(params, jnp.asarray(tok), 20,
                                  pad_lens=jnp.asarray(PADS),
                                  return_stats=True)
    pre = [np.asarray(c) for c in jax.tree.leaves(cache)]
    step, cache, st2 = m.decode_step(params, cache,
                                     jnp.asarray(tok[:, -1:]), 9,
                                     pad_lens=jnp.asarray(PADS),
                                     return_stats=True)
    return dict(case=request.param, params=_np(params), tok=tok,
                prefill=np.asarray(logits), decode=np.asarray(step),
                poison=(int(st["moe_poison"]), int(st2["moe_poison"])),
                pre=pre, post=[np.asarray(c) for c in jax.tree.leaves(cache)])


@pytest.mark.parametrize("dispatch", ["spec", "spec-kernel"])
def test_model_matches_reference(model_reference, dispatch):
    r = model_reference
    _, cfg = _cfgs(r["case"])
    m = build_model(cfg, dispatch)
    params = params_from_numpy(r["params"])
    logits, cache, st = m.prefill(params, _t(r["tok"]), 20,
                                  pad_lens=_t(PADS), return_stats=True)
    _close(logits, r["prefill"])

    def leaves(cache):
        caches, states = cache
        return (_port_caches(caches) if caches else []) + \
            _port_states(states)

    got = leaves(cache)
    assert len(got) == len(r["pre"])
    for g, w in zip(got, r["pre"]):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w)
    step, cache, st2 = m.decode_step(params, cache, _t(r["tok"][:, -1:]), 9,
                                     pad_lens=_t(PADS), return_stats=True)
    _close(step, r["decode"])
    for g, w in zip(leaves(cache), r["post"]):
        _close(g, w)
    assert (int(st["moe_poison"]), int(st2["moe_poison"])) == r["poison"]
    if cfg.family == "hybrid":
        assert r["poison"][0] > 0, "no capacity race"


def test_model_spec_kernel_bitwise_spec():
    """Jamba's MoE sublayers through the spec kernels' plain versions
    commit the bits of dispatch="spec", poison counts included."""
    _, cfg = _cfgs("jamba_1_5_large_398b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    tok = _t(_tokens(cfg))
    runs = {}
    for dispatch in ("spec", "spec-kernel"):
        m = build_model(cfg, dispatch)
        lp, cache, st = m.prefill(params, tok, 16, pad_lens=_t(PADS),
                                  return_stats=True)
        ld, cache, st2 = m.decode_step(params, cache, tok[:, -1:], 9,
                                       pad_lens=_t(PADS), return_stats=True)
        runs[dispatch] = (lp, ld, _port_states(cache[1]),
                          int(st["moe_poison"]), int(st2["moe_poison"]))
    a, b = runs["spec"], runs["spec-kernel"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
    assert a[3:] == b[3:] and a[3] > 0


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
def test_model_prefill_then_decode_equals_longer_prefill(arch):
    """Prefill of T tokens then one decode step: the logits and SSM states
    of a prefill of all T + 1 tokens."""
    cfg = base.smoke(base.get(arch))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    tok = _t(_tokens(cfg, t=T + 1))
    want, (_, wstates) = m.prefill(params, tok, 16)
    _, cache = m.prefill(params, tok[:, :T], 16)
    got, (_, gstates) = m.decode_step(params, cache, tok[:, T:], T)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for a, b in zip(_port_states(gstates), _port_states(wstates)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(arch, dtype):
    """Shapes and dtypes of the reference's ``init_cache``: float32 SSM
    states whatever the config's dtype, KV caches in it."""
    rcfg = dataclasses.replace(rbase.smoke(rbase.get(arch)), dtype=dtype)
    cfg = dataclasses.replace(base.smoke(base.get(arch)), dtype=dtype)
    want = jax.eval_shape(lambda: rbuild(rcfg).init_cache(3, 12))
    caches, states = build_model(cfg).init_cache(3, 12)
    got = (_port_caches(caches) if caches else []) + _port_states(states)
    want_leaves = jax.tree.leaves(want)
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        assert tuple(g.shape) == w.shape
        assert g.dtype == getattr(torch, w.dtype.name)
        assert not g.any()
    assert (caches is None) == (cfg.family == "ssm")


@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
def test_params_from_numpy_bfloat16_bits(arch):
    """A bf16 reference tree converts bit for bit; Mamba's a_log stays
    float32 inside it."""
    rcfg = dataclasses.replace(rbase.smoke(rbase.get(arch)),
                               dtype="bfloat16")
    tree = _np(rbuild(rcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree)
    n_groups = len(params["groups"])
    assert n_groups == len(jax.tree.leaves(tree["groups"])[0])
    for sub, leaves in tree["groups"].items():
        for name, stacked in leaves.items():
            for g in range(n_groups):
                got = params["groups"][g][sub][name]
                want = stacked[g]
                if name == "a_log":
                    assert want.dtype == np.float32
                    assert got.dtype == torch.float32
                    np.testing.assert_array_equal(got.numpy(), want)
                else:
                    assert got.dtype == torch.bfloat16, (sub, name)
                    np.testing.assert_array_equal(
                        got.view(torch.int16).numpy(), want.view(np.int16))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_LEGS = [("rwkv6_7b", "spec"), ("jamba_1_5_large_398b", "spec"),
               ("jamba_1_5_large_398b", "spec-kernel")]


def _stats(waves):
    return [(w.batch, w.tokens, w.moe_poison, w.moe_requests, w.truncated)
            for w in waves]


@pytest.fixture(scope="module", params=["rwkv6_7b", "jamba_1_5_large_398b"])
def engine_reference(request):
    """One reference run (dispatch="spec"): five ragged requests over two
    left-padded waves of three slots, one truncated at max_len; Jamba at a
    capacity that poisons."""
    cfg = rbase.smoke(rbase.get(request.param))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    eng = REngine(cfg, slots=3, max_len=20, dispatch="spec")
    rng = _rng(4)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (4, 7, 3, 9, 13)]
    max_new = [5, 3, 6, 4, 9]
    reqs = [RRequest(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    res = eng.run(reqs)
    return dict(arch=request.param, cfg=cfg, prompts=prompts,
                max_new=max_new, params=_np(eng.params), results=res,
                stats=_stats(eng.wave_stats),
                truncated=[r.truncated for r in reqs],
                events=[(e.site, e.outcome) for e in eng.events])


@pytest.mark.parametrize("dispatch", ["spec", "spec-kernel"])
def test_engine_tokens_match_reference(engine_reference, dispatch):
    r = engine_reference
    cfg = dataclasses.replace(base.smoke(base.get(r["arch"])),
                              capacity_factor=r["cfg"].capacity_factor)
    eng = Engine(cfg, params_from_numpy(r["params"]), slots=3, max_len=20,
                 dispatch=dispatch, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(r["prompts"], r["max_new"]))]
    assert eng.run(reqs) == r["results"]
    assert _stats(eng.wave_stats) == r["stats"]
    assert [q.truncated for q in reqs] == r["truncated"]
    assert [(e.site, e.outcome) for e in eng.events] == r["events"]
    assert any(r["truncated"]) and len(r["stats"]) == 2
    if cfg.family == "hybrid":
        # 4 MoE sublayers in Jamba's group, top-2
        assert eng._moe_per_tok == 4 * cfg.top_k
        assert sum(s[2] for s in r["stats"]) > 0, "no capacity race"


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_launcher_serves_on_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--requests", "3",
                              "--max-new", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out and "on cpu" in out
