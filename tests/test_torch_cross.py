"""The vlm and encdec families of the port (cross-attention and the
enc-dec encoder: Llama-3.2-Vision, Whisper) against the JAX reference,
on the CPU, float32 at ``atol = rtol = 1e-4``.

* ``gqa_attention(cross_kv=...)``: no RoPE, not causal, no cache, no pad
  mask, over memories shorter and longer than one 512-key chunk;
* ``Model._encode`` over stub frames (bidirectional);
* the model (``smoke`` configs of ``llama_3_2_vision_90b`` and
  ``whisper_medium``): prefill and decode logits and KV caches with stub
  ``memory``, left-padded, on the reference's own parameters.  Both
  packages encode the enc-dec family's memory in prefill only and
  cross-attend to it as passed in decode;
* ``params_from_numpy`` with ``enc_groups``, float32 and bf16 bit for
  bit; a cross sublayer without memory raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.models import layers as rlayers
from repro.models.model import build_model as rbuild
from repro_torch.configs import base
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model

TOL = dict(atol=1e-4, rtol=1e-4)
PADS = np.array([0, 3, 5], np.int32)
ARCHS = ("llama_3_2_vision_90b", "whisper_medium")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _memory(cfg, seed=2, b=3):
    s = cfg.enc_len if cfg.family == "encdec" else cfg.n_patches
    return _randn(_rng(seed), b, s, cfg.d_model)


@pytest.mark.parametrize("h,hkv,s", [(4, 2, 16), (4, 4, 24), (4, 1, 600)])
def test_gqa_attention_cross_matches_reference(h, hkv, s):
    """600 keys: two chunks, the last zero-padded and masked."""
    rng = _rng(1)
    d, hd, b, t = 64, 16, 2, 5
    p = {"wq": _randn(rng, d, h * hd, scale=0.1),
         "wo": _randn(rng, h * hd, d, scale=0.1)}
    x = _randn(rng, b, t, d)
    k, v = _randn(rng, b, hkv, s, hd), _randn(rng, b, hkv, s, hd)
    kw = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd, theta=1e4,
              pos_offset=7)
    want, wcache = rlayers.gqa_attention(p, x, cross_kv=(k, v), **kw)
    got, gcache = layers.gqa_attention({n: _t(a) for n, a in p.items()},
                                       _t(x), cross_kv=(_t(k), _t(v)), **kw)
    assert gcache is None and wcache is None
    _close(got, want)
    # no RoPE and no causal mask: the queries' positions do not matter
    again, _ = layers.gqa_attention({n: _t(a) for n, a in p.items()},
                                    _t(x), cross_kv=(_t(k), _t(v)),
                                    **dict(kw, pos_offset=0))
    assert torch.equal(got, again)


@pytest.fixture(scope="module", params=ARCHS)
def model_reference(request):
    """Reference parameters, prefill (left-padded) with stub memory and
    one decode step with the same memory."""
    cfg = rbase.smoke(rbase.get(request.param))
    m = rbuild(cfg)
    params = m.init(jax.random.PRNGKey(0))
    tok = _rng(1).integers(1, cfg.vocab, (3, 9)).astype(np.int32)
    mem = _memory(cfg)
    logits, cache = m.prefill(params, jnp.asarray(tok), 20, memory=mem,
                              pad_lens=jnp.asarray(PADS))
    pre = [np.asarray(c) for c in jax.tree.leaves(cache)]
    step, cache = m.decode_step(params, cache, jnp.asarray(tok[:, -1:]), 9,
                                memory=mem, pad_lens=jnp.asarray(PADS))
    return dict(arch=request.param, params=jax.tree.map(np.asarray, params),
                tok=tok, mem=mem, prefill=np.asarray(logits),
                decode=np.asarray(step), pre=pre,
                post=[np.asarray(c) for c in jax.tree.leaves(cache)])


def _caches(caches):
    return [torch.stack([g[a][j] for g in caches])
            for a in range(len(caches[0])) for j in range(2)]


def test_model_matches_reference(model_reference):
    r = model_reference
    cfg = base.smoke(base.get(r["arch"]))
    m = build_model(cfg)
    params = params_from_numpy(r["params"])
    mem = _t(r["mem"])
    logits, cache = m.prefill(params, _t(r["tok"]), 20, memory=mem,
                              pad_lens=_t(PADS))
    _close(logits, r["prefill"])
    caches, states = cache
    assert states is None
    for g, w in zip(_caches(caches), r["pre"], strict=True):
        _close(g, w)
    step, cache = m.decode_step(params, cache, _t(r["tok"][:, -1:]), 9,
                                memory=mem, pad_lens=_t(PADS))
    _close(step, r["decode"])
    for g, w in zip(_caches(cache[0]), r["post"], strict=True):
        _close(g, w)


def test_encode_matches_reference():
    """Whisper's encoder over stub frames, with its own final norm."""
    rcfg = rbase.smoke(rbase.get("whisper_medium"))
    rm = rbuild(rcfg)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(3)))
    frames = _memory(rcfg, seed=5)
    want = rm._encode(tree, jnp.asarray(frames))
    cfg = base.smoke(base.get("whisper_medium"))
    got = build_model(cfg)._encode(params_from_numpy(tree), _t(frames))
    assert got.shape == (3, cfg.enc_len, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_enc_groups(dtype):
    """The encoder's stacked n_enc_layers axis unstacks like groups',
    values and dtypes bit for bit."""
    rcfg = dataclasses.replace(rbase.smoke(rbase.get("whisper_medium")),
                               dtype=dtype)
    tree = jax.tree.map(np.asarray, rbuild(rcfg).init(jax.random.PRNGKey(0)))
    params = params_from_numpy(tree)
    assert len(params["enc_groups"]) == rcfg.n_enc_layers
    assert len(params["groups"]) == rcfg.n_layers
    bits = (lambda a: a.view(np.int16)) if dtype == "bfloat16" else (
        lambda a: a)
    for key in ("groups", "enc_groups"):
        for sub, leaves in tree[key].items():
            for name, stacked in leaves.items():
                for i, layer in enumerate(params[key]):
                    got = layer[sub][name]
                    assert got.dtype == getattr(torch, dtype)
                    got = (got.view(torch.int16) if dtype == "bfloat16"
                           else got).numpy()
                    np.testing.assert_array_equal(got, bits(stacked[i]))
    for name in ("enc_ln_f", "ln_f", "embed", "lm_head"):
        assert tuple(params[name].shape) == tree[name].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_runs_with_memory(arch):
    """The smoke configs in bf16 with bf16 memory: finite bf16 logits of
    the reference's shape."""
    cfg = dataclasses.replace(base.smoke(base.get(arch)), dtype="bfloat16")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    tok = _t(_rng(1).integers(1, cfg.vocab, (3, 9)).astype(np.int32))
    mem = _t(_memory(cfg).astype(ml_dtypes.bfloat16).view(np.int16)).view(
        torch.bfloat16)
    logits, cache = m.prefill(params, tok, 12, memory=mem)
    step, _ = m.decode_step(params, cache, tok[:, -1:], 9, memory=mem)
    for out in (logits, step):
        assert out.shape == (3, cfg.vocab)
        assert out.dtype == torch.bfloat16
        assert torch.isfinite(out.float()).all()


def test_cross_without_memory_raises():
    cfg = base.smoke(base.get("llama_3_2_vision_90b"))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="needs memory"):
        m.prefill(params, torch.ones((1, 4), dtype=torch.int32), 8)
