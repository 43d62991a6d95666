"""The port's configs and model stack (repro_torch.configs, .models)
against the JAX reference, on the CPU.

* configs: ``dataclasses.asdict`` of every assigned config and its smoke
  variant equal to the reference's, ``param_count`` equal;
* layers: each function on the same seeded inputs, ``atol = rtol = 1e-4``;
* MoE (flat path): slot assignment and gates bitwise, ``kernel`` on and
  off bitwise within the port, outputs against the reference at
  ``atol = rtol = 1e-4``, poison counts equal;
* router ties: with a zero router and with a bf16 router at Kimi-K2's
  width, expert order, slots and poison counts bitwise equal to
  ``jax.lax.top_k``'s (the lower expert first among equal gates);
* the model: prefill and decode logits at ``atol = rtol = 1e-4`` and poison
  counts equal, on the reference's own parameters (``params_from_numpy``),
  for the Kimi-K2 (moe) and Granite-34B (dense) smoke configs, float32
  (the other families: ``tests/test_torch_ssm.py``,
  ``tests/test_torch_cross.py``); every family's group pattern, and its
  init's shapes, dtypes and distributions.

The reference's ``spec-kernel`` runs reach its Pallas kernels in interpret
mode, as ``tests/test_moe_serve.py`` runs them; each reference run is
made once per module and shared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import layers as rlayers
from repro.models import moe as rmoe
from repro.models.model import build_model as rbuild
from repro.models.model import group_count as rgroup_count
from repro.models.model import group_pattern as rgroup_pattern
from repro_torch.configs import base
from repro_torch.kernels.spec_gather import spec_gather
from repro_torch.kernels.spec_scatter import spec_scatter_add
from repro_torch.models import layers, model as tmodel, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("kimi_k2_1t_a32b", "granite_34b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", rbase.ASSIGNED)
def test_config_matches_reference(name):
    ref, got = rbase.get(name), base.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert dataclasses.asdict(base.smoke(got)) == \
        dataclasses.asdict(rbase.smoke(ref))
    assert base.param_count(got) == rbase.param_count(ref)
    assert (got.hd, got.attention_free, got.sub_quadratic) == \
        (ref.hd, ref.attention_free, ref.sub_quadratic)
    assert got.torch_dtype == getattr(torch, ref.jdtype.name)
    assert base.smoke(got).torch_dtype == torch.float32
    assert base.get(ref.name) is got  # the dashed alias


def test_config_registry_matches_reference():
    assert base.ASSIGNED == rbase.ASSIGNED
    assert base._ALIASES == rbase._ALIASES


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_and_swiglu_match_reference():
    rng = _rng()
    x, s = _randn(rng, 2, 5, 64), _randn(rng, 64)
    _close(layers.rms_norm(_t(x), _t(s)), rlayers.rms_norm(x, s))
    wg, wu = _randn(rng, 64, 96, scale=0.1), _randn(rng, 64, 96, scale=0.1)
    wd = _randn(rng, 96, 64, scale=0.1)
    _close(layers.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           rlayers.swiglu(x, wg, wu, wd))


@pytest.mark.parametrize("batched_pos", [False, True])
def test_rope_matches_reference(batched_pos):
    rng = _rng(1)
    x = _randn(rng, 3, 7, 4, 16)
    pos = (rng.integers(0, 40, (3, 7)) if batched_pos
           else np.arange(5, 12)).astype(np.int32)
    _close(layers.rope(_t(x), _t(pos), 1e4), rlayers.rope(x, pos, 1e4))


@pytest.mark.parametrize("causal,tk,chunk,q_offset", [
    (True, 9, 512, 0), (False, 9, 4, 0), (True, 13, 4, 4), (False, 5, 8, 0)])
def test_chunked_attention_matches_reference(causal, tk, chunk, q_offset):
    rng = _rng(2)
    q = _randn(rng, 2, 3, 9 if causal else 6, 16)
    k, v = _randn(rng, 2, 3, tk, 16), _randn(rng, 2, 3, tk, 16)
    got = layers.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                   chunk=chunk, q_offset=q_offset)
    want = rlayers.chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                     q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("t,pad", [(1, False), (1, True), (6, True),
                                   (6, False)])
def test_decode_attention_matches_reference(t, pad):
    """Pad rows included: a query row with no live key gets the finite
    NEG_INF's uniform softmax, as in the reference."""
    rng = _rng(3)
    q = _randn(rng, 3, 4, t, 16)
    ck, cv = _randn(rng, 3, 4, 10, 16), _randn(rng, 3, 4, 10, 16)
    pads = np.array([0, 2, 5], np.int32) if pad else None
    got = layers._decode_attention(_t(q), _t(ck), _t(cv), 8,
                                   pad_len=None if pads is None
                                   else _t(pads))
    want = rlayers._decode_attention(q, ck, cv, 8, pad_len=pads)
    _close(got, want)
    assert layers.NEG_INF == rlayers.NEG_INF == -1e30


@pytest.mark.parametrize("cache", [False, True])
def test_gqa_attention_matches_reference(cache):
    rng = _rng(4)
    d, h, hkv, hd, b, t = 64, 4, 2, 16, 2, 5
    p = {"wq": _randn(rng, d, h * hd, scale=0.1),
         "wk": _randn(rng, d, hkv * hd, scale=0.1),
         "wv": _randn(rng, d, hkv * hd, scale=0.1),
         "wo": _randn(rng, h * hd, d, scale=0.1)}
    x = _randn(rng, b, t, d)
    kw = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd, theta=1e4)
    pads = np.array([0, 3], np.int32)
    tp = {k: _t(v) for k, v in p.items()}
    if cache:
        ck = np.zeros((b, hkv, 12, hd), np.float32)
        want, (wk, wv) = rlayers.gqa_attention(
            p, x, kv_cache=(ck, ck), cache_len=2, pos_offset=2,
            pad_len=pads, **kw)
        tk, tv = _t(ck), _t(ck)
        got, (gk, gv) = layers.gqa_attention(
            tp, _t(x), kv_cache=(tk, tv), cache_len=2, pos_offset=2,
            pad_len=_t(pads), **kw)
        _close(gk, wk)
        _close(gv, wv)
        assert gk is tk  # written in place
    else:
        want, _ = rlayers.gqa_attention(p, x, **kw)
        got, _ = layers.gqa_attention(tp, _t(x), **kw)
    _close(got, want)


# ---------------------------------------------------------------------------
# MoE: the flat speculative dispatch
# ---------------------------------------------------------------------------

CFG = base.smoke(base.get("kimi_k2_1t_a32b"))
RCFG = rbase.smoke(rbase.get("kimi_k2_1t_a32b"))


@pytest.fixture(scope="module")
def moe_case():
    """The reference's MoE sublayer parameters (group 0) and a batch."""
    groups = rbuild(RCFG).init(jax.random.PRNGKey(0))["groups"]
    p = _np(jax.tree.map(lambda a: a[0], groups)["s1_moe"])
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (64, RCFG.d_model), jnp.float32))
    return p, x


@pytest.fixture(scope="module")
def moe_reference(moe_case):
    """The reference's flat dispatch, lax and kernel, at two capacities."""
    p, x = moe_case
    out = {}
    for cf in (1.25, 0.5):
        kw = dict(n_experts=RCFG.n_experts, top_k=RCFG.top_k,
                  capacity_factor=cf)
        for kernel in (False, True):
            o, n = rmoe._moe_spec_flat(p, x, kernel=kernel, stats=True, **kw)
            out[cf, kernel] = (np.asarray(o), int(n))
    return out


@pytest.mark.parametrize("n,k,e,cap", [(40, 2, 4, 8), (40, 2, 4, 3),
                                       (40, 2, 4, 1), (300, 8, 384, 8),
                                       (512, 8, 16, 112)])
def test_spec_dispatch_indices_bitexact(n, k, e, cap):
    """Slots (int32) and gates equal the reference's bit for bit, with
    many requests per expert so positions pass the capacity."""
    rng = _rng(5)
    experts = np.stack([rng.permutation(e)[:k] for _ in range(n)]).astype(
        np.int32)
    gates = rng.random((n, k)).astype(np.float32)
    slot, g = moe.spec_dispatch_indices(_t(gates), _t(experts), cap, e)
    rslot, rg = rmoe.spec_dispatch_indices(gates, experts, cap, e)
    assert slot.dtype == torch.int32
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(g.numpy(), np.asarray(rg))
    arrivals = np.bincount(experts.ravel(), minlength=e)
    assert int((slot.numpy() < 0).sum()) == int(np.maximum(
        arrivals - cap, 0).sum())


@pytest.mark.parametrize("n,experts,k,f", [
    (64, 4, 2, 1.25), (2048, 384, 8, 1.25), (4096, 384, 8, 1.25),
    (8, 384, 8, 1.25), (13, 5, 3, 0.5)])
def test_round_capacity_matches_reference(n, experts, k, f):
    assert moe.round_capacity(n, experts, k, f) == \
        rmoe.round_capacity(n, experts, k, f)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_spec_flat_matches_reference(moe_case, moe_reference, cf):
    """kernel on and off bitwise within the port; both at 1e-4 against the
    reference, poison counts equal (and > 0 at the low capacity)."""
    p, x = moe_case
    tp = {k: _t(v) for k, v in p.items()}
    kw = dict(n_experts=CFG.n_experts, top_k=CFG.top_k, capacity_factor=cf)
    plain, n_plain = moe.moe_spec(tp, _t(x), stats=True, **kw)
    kern, n_kern = moe.moe_spec(tp, _t(x), kernel=True, stats=True, **kw)
    assert torch.equal(plain, kern)
    assert n_plain.dtype == torch.int32
    want, n_want = moe_reference[cf, True]
    assert int(n_plain) == int(n_kern) == n_want == moe_reference[cf, False][1]
    _close(plain, want)
    if cf == 0.5:
        assert n_want > 0
    assert torch.equal(moe.moe_spec(tp, _t(x), **kw), plain)


def test_spec_matches_dense_when_unpoisoned(moe_case):
    """With generous capacity (no poison) the speculative paths agree with
    the dense if-converted baseline, which agrees with the reference's."""
    p, x = moe_case
    x = x[:32]
    tp = {k: _t(v) for k, v in p.items()}
    kw = dict(n_experts=CFG.n_experts, top_k=CFG.top_k)
    spec, pois = moe.moe_spec(tp, _t(x), capacity_factor=4.0, stats=True,
                              **kw)
    kern = moe.moe_spec(tp, _t(x), capacity_factor=4.0, kernel=True, **kw)
    dense, dpois = moe.moe_dense(tp, _t(x), stats=True, **kw)
    assert int(pois) == 0 and int(dpois) == 0
    assert torch.equal(spec, kern)
    torch.testing.assert_close(spec, dense, atol=1e-5, rtol=1e-5)
    _close(dense, rmoe.moe_dense(p, x, **kw))


def test_moe_kernel_path_launches_nothing_on_cpu(moe_case):
    """On CPU tensors the spec kernels' wrappers take their plain versions:
    no launch is counted."""
    p, x = moe_case
    tp = {k: _t(v) for k, v in p.items()}
    before = (spec_gather.launches, spec_scatter_add.launches)
    moe.moe_spec(tp, _t(x), n_experts=CFG.n_experts, top_k=CFG.top_k,
                 capacity_factor=1.25, kernel=True)
    assert (spec_gather.launches, spec_scatter_add.launches) == before


# ---------------------------------------------------------------------------
# router ties: the lower expert first, as jax.lax.top_k
# ---------------------------------------------------------------------------

#: Kimi-K2's router: d_model 7168, 384 experts, top-8
KIMI_D, KIMI_E, KIMI_K = 7168, 384, 8


def _ref_route(router, x, top_k):
    """The reference's routing (``_moe_spec_flat``'s first lines)."""
    logits = jnp.einsum("nd,de->ne", x, router)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gates, experts = jax.lax.top_k(probs, top_k)
    return np.asarray(logits), np.asarray(gates), np.asarray(experts)


#: softmax's float32 rounding differs between the packages by an ulp
GATE_TOL = dict(rtol=1e-6, atol=0)


def _assert_route_matches(router, x, top_k, n_experts, cf):
    """Expert order, slots and poison count bitwise; gates at
    ``GATE_TOL``."""
    _, rgates, rexperts = _ref_route(router, x, top_k)
    tr = _t(router) if router.dtype == np.float32 else _bf16(router)
    tx = _t(x) if x.dtype == np.float32 else _bf16(x)
    _, gates, experts = moe._route({"router": tr}, tx, top_k)
    np.testing.assert_array_equal(experts.numpy(), rexperts)
    np.testing.assert_allclose(gates.numpy(), rgates, **GATE_TOL)
    cap = moe.round_capacity(x.shape[0], n_experts, top_k, cf)
    slot, g = moe.spec_dispatch_indices(gates, experts, cap, n_experts)
    rslot, rg = rmoe.spec_dispatch_indices(rgates, rexperts, cap, n_experts)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), **GATE_TOL)
    return int((slot < 0).sum())


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
        torch.bfloat16)


def test_route_zero_router_takes_lowest_experts():
    """Every probability equal: the reference picks experts 0..k-1 in
    order on every row, and so must the port (torch.topk need not)."""
    x = _randn(_rng(6), 96, 64)
    router = np.zeros((64, KIMI_E), np.float32)
    n_poison = _assert_route_matches(router, x, KIMI_K, KIMI_E, 1.25)
    _, _, experts = moe._route({"router": _t(router)}, _t(x), KIMI_K)
    assert (experts.numpy() == np.arange(KIMI_K)).all()
    # 96 rows all on experts 0..7 at capacity 8: most requests poisoned
    assert n_poison == 96 * KIMI_K - KIMI_K * 8


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_spec_zero_router_matches_reference(moe_case, cf):
    """The smoke MoE with its router zeroed (every gate tied): outputs at
    1e-4, poison counts bitwise, kernel on and off alike."""
    p, x = moe_case
    p = dict(p, router=np.zeros_like(p["router"]))
    tp = {k: _t(v) for k, v in p.items()}
    kw = dict(n_experts=CFG.n_experts, top_k=CFG.top_k, capacity_factor=cf)
    n_poison = _assert_route_matches(p["router"], x, CFG.top_k,
                                     CFG.n_experts, cf)
    want, n_want = rmoe._moe_spec_flat(p, x, stats=True, **kw)
    for kernel in (False, True):
        got, n_got = moe.moe_spec(tp, _t(x), kernel=kernel, stats=True, **kw)
        assert int(n_got) == int(n_want) == n_poison > 0
        _close(got, want)


@pytest.fixture(scope="module")
def kimi_bf16_router():
    """A bf16 router at Kimi-K2's width where ties are common: x in
    {-3..3} and router weights in {-4..4}/256, so every product is a
    multiple of 2**-8 and every float32 partial sum is exact; both
    packages then round the same sum to the same bf16 logit whatever
    their summation order, and the test holds the tie order alone."""
    import ml_dtypes
    rng = _rng(7)
    x = rng.integers(-3, 4, (256, KIMI_D)).astype(ml_dtypes.bfloat16)
    router = (rng.integers(-4, 5, (KIMI_D, KIMI_E)) / 256).astype(
        ml_dtypes.bfloat16)
    return router, x


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_bf16_kimi_width_ties_match_reference(kimi_bf16_router, cf):
    router, x = kimi_bf16_router
    logits, _, _ = _ref_route(router, x, KIMI_K)
    tlogits = (_bf16(x) @ _bf16(router)).float().numpy()
    np.testing.assert_array_equal(tlogits, logits.astype(np.float32))
    # ties inside the top-k are common at this width: the test has teeth
    top = -np.sort(-logits.astype(np.float32), axis=1)[:, :KIMI_K]
    assert (np.diff(top, axis=1) == 0).any(axis=1).sum() > 64
    n_poison = _assert_route_matches(router, x, KIMI_K, KIMI_E, cf)
    assert n_poison > 0


def test_moe_spec_bf16_kimi_width_poison_matches_reference(kimi_bf16_router):
    """moe_spec on the tied bf16 router, with narrow experts (d_ff 8):
    the poison count equals the reference's, kernel on and off."""
    router, x = kimi_bf16_router
    import ml_dtypes
    rng = _rng(8)
    w = {k: (rng.standard_normal(s) * 0.02).astype(ml_dtypes.bfloat16)
         for k, s in (("w_gate", (KIMI_E, KIMI_D, 8)),
                      ("w_up", (KIMI_E, KIMI_D, 8)),
                      ("w_down", (KIMI_E, 8, KIMI_D)))}
    p = dict(w, router=router)
    kw = dict(n_experts=KIMI_E, top_k=KIMI_K, capacity_factor=0.5)
    _, n_want = rmoe._moe_spec_flat(p, x, stats=True, **kw)
    tp = {k: _bf16(v) for k, v in p.items()}
    for kernel in (False, True):
        _, n_got = moe.moe_spec(tp, _bf16(x), kernel=kernel, stats=True,
                                **kw)
        assert int(n_got) == int(n_want) > 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

PADS = np.array([0, 3, 5], np.int32)


def _tokens(cfg, seed=1):
    return _rng(seed).integers(1, cfg.vocab, (3, 9)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model_reference(request):
    """Reference parameters, prefill and decode (spec-kernel dispatch for
    the moe family) with poison stats."""
    cfg = rbase.smoke(rbase.get(request.param))
    dispatch = "spec-kernel" if cfg.family == "moe" else "spec"
    m = rbuild(cfg, dispatch)
    params = m.init(jax.random.PRNGKey(0))
    tok = _tokens(cfg)
    logits, cache, st = m.prefill(params, jnp.asarray(tok), 20,
                                  pad_lens=jnp.asarray(PADS),
                                  return_stats=True)
    step, _, st2 = m.decode_step(params, cache, jnp.asarray(tok[:, -1:]), 9,
                                 pad_lens=jnp.asarray(PADS),
                                 return_stats=True)
    return dict(arch=request.param, dispatch=dispatch,
                params=_np(params), tok=tok,
                prefill=np.asarray(logits), decode=np.asarray(step),
                poison=(int(st["moe_poison"]), int(st2["moe_poison"])),
                cache=[np.asarray(c) for c in jax.tree.leaves(cache)])


def test_model_logits_match_reference(model_reference):
    r = model_reference
    cfg = base.smoke(base.get(r["arch"]))
    m = build_model(cfg, r["dispatch"])
    params = params_from_numpy(r["params"])
    logits, cache, st = m.prefill(params, _t(r["tok"]), 20,
                                  pad_lens=_t(PADS), return_stats=True)
    _close(logits, r["prefill"])
    # the caches after prefill: group-stacked in the reference
    caches, states = cache
    assert states is None
    for i, want in enumerate(r["cache"]):
        got = torch.stack([g[0][i] for g in caches])
        _close(got, want)
    step, _, st2 = m.decode_step(params, cache, _t(r["tok"][:, -1:]), 9,
                                 pad_lens=_t(PADS), return_stats=True)
    _close(step, r["decode"])
    assert (int(st["moe_poison"]), int(st2["moe_poison"])) == r["poison"]
    assert logits.shape == (3, cfg.vocab) and logits.dtype == torch.float32


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_model_dispatch_spec_kernel_bitexact(cf):
    """End to end, prefill and decode: dispatch="spec-kernel" is bitwise
    dispatch="spec", and both report the same poison counts (forced above
    zero at the low capacity factor)."""
    cfg = dataclasses.replace(CFG, capacity_factor=cf)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    tok = torch.from_numpy(_tokens(cfg))
    pads = _t(PADS)
    runs = {}
    for dispatch in ("spec", "spec-kernel"):
        m = build_model(cfg, dispatch)
        lp, cache, st = m.prefill(params, tok, 16, pad_lens=pads,
                                  return_stats=True)
        ld, _, st2 = m.decode_step(params, cache, tok[:, -1:], 9,
                                   pad_lens=pads, return_stats=True)
        runs[dispatch] = (lp, ld, int(st["moe_poison"]),
                          int(st2["moe_poison"]))
    a, b = runs["spec"], runs["spec-kernel"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2:] == b[2:]
    if cf < 1:
        assert a[2] > 0


#: one config of each family: moe, dense, ssm, hybrid, vlm, encdec
FAMILIES = ("kimi_k2_1t_a32b", "granite_34b", "rwkv6_7b",
            "jamba_1_5_large_398b", "llama_3_2_vision_90b", "whisper_medium")


@pytest.mark.parametrize("name", rbase.ASSIGNED)
def test_group_pattern_matches_reference(name):
    ref, got = rbase.get(name), base.get(name)
    for r, g in ((ref, got), (rbase.smoke(ref), base.smoke(got))):
        assert tmodel.group_pattern(g) == rgroup_pattern(r)
        assert tmodel.group_count(g) == rgroup_count(r)


@pytest.mark.parametrize("name", FAMILIES)
def test_init_matches_reference_shapes_and_distribution(monkeypatch, name):
    """The port's init draws the reference's tree of shapes and dtypes
    (encoder included): matrices normal x 0.02, norms 1, RWKV's mu 0.5 and
    w_bias 2.0, Mamba's a_log float32 zeros; drawn in slices (the slice
    forced small here), the same seed giving the same parameters."""
    monkeypatch.setattr(tmodel, "INIT_SLICE", 1000)
    rcfg, cfg = rbase.smoke(rbase.get(name)), base.smoke(base.get(name))
    ref = jax.eval_shape(rbuild(rcfg).init, jax.random.PRNGKey(0))
    m = build_model(cfg)
    got = m.init(torch.Generator().manual_seed(3), "cpu")
    again = m.init(torch.Generator().manual_seed(3), "cpu")
    assert sorted(got) == sorted(ref)
    consts = {"ln": 1.0, "mu": 0.5, "w_bias": 2.0, "a_log": 0.0}
    for key in ("groups", "enc_groups"):
        if key not in ref:
            continue
        n = jax.tree.leaves(ref[key])[0].shape[0]
        assert len(got[key]) == n
        for g, gp in enumerate(got[key]):
            assert sorted(gp) == sorted(ref[key])
            for sub, leaves in gp.items():
                assert sorted(leaves) == sorted(ref[key][sub])
                for pname, t in leaves.items():
                    want = ref[key][sub][pname]
                    assert tuple(t.shape) == tuple(want.shape[1:]), (
                        sub, pname)
                    assert t.dtype == getattr(torch, want.dtype.name)
                    assert torch.equal(t, again[key][g][sub][pname])
                    if pname in consts:
                        assert (t == consts[pname]).all(), (sub, pname)
    for pname in ("embed", "lm_head", "ln_f", "enc_ln_f"):
        if pname in ref:
            assert tuple(got[pname].shape) == tuple(ref[pname].shape)
    e = got["embed"]
    assert abs(float(e.std()) - 0.02) < 0.002 and abs(float(e.mean())) < 2e-3
    if cfg.family == "ssm":
        ww = torch.cat([gp["s0_rwkv"]["ww"].ravel() for gp in got["groups"]])
        assert abs(float(ww.std()) - 0.01) < 0.001


def test_init_in_config_dtype():
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    p = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    assert p["embed"].dtype == torch.bfloat16
    assert p["groups"][0]["s1_moe"]["w_gate"].dtype == torch.bfloat16
    # Mamba's a_log stays float32 in a bf16 model, as the reference's
    jamba = dataclasses.replace(base.smoke(base.get("jamba_1_5_large_398b")),
                                dtype="bfloat16")
    p = build_model(jamba).init(torch.Generator().manual_seed(0), "cpu")
    assert p["groups"][0]["s0_mamba"]["a_log"].dtype == torch.float32
    assert p["groups"][0]["s0_mamba"]["in_proj"].dtype == torch.bfloat16


def test_params_from_numpy_bfloat16_bits():
    """A bf16 reference tree converts bit for bit."""
    cfg = dataclasses.replace(RCFG, dtype="bfloat16")
    tree = _np(rbuild(cfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree)
    got = params["groups"][1]["s1_moe"]["w_up"]
    want = tree["groups"]["s1_moe"]["w_up"][1]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
