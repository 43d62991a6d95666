"""The chunked-attention routes of the port (``repro_torch.kernels.
chunked_attention``) on the CPU: what runs here of them, against the
reference's ``repro.models.layers.chunked_attention`` (plain JAX on the
CPU).

* the head widths 112 (Kimi-K2) and 160 (StableLM-12B), which the CUDA
  kernels are built for since the routes were redesigned: the entry's
  forward (float32 and bfloat16), its gradients through autograd, and
  the plain backward ``ref.chunked_attention_bwd`` (every backward
  route's algorithm) against the reference and ``jax.vjp``, at
  ``tests/test_torch_chunked_attention.py``'s tolerances;
* ``attn_plan`` / ``attn_bwd_plan`` give the expected route at the main
  paths' shapes (those of ``chip_smoke.py``'s ``ATTN_PATHS``) and at
  every edge (float32, the split threshold, each head width, an
  unaligned base, the head route's limits), on meta tensors, so no kernel
  is needed;
* every attention a smoke config's model runs in a training step (self
  attention at the training length, the encoder, cross attention), and
  its one-query decode, plans to the ``head`` route forward and backward,
  in float32 and for Jamba's smoke config in bfloat16; past the route's
  limits the plans are the other routes'; its shared memory stays within
  48 KB up to the limit, and the limits are the kernel source's;
* every config with attention under ``src/repro_torch/configs/`` (and
  its smoke config) has a head width the kernels are built for and a
  route forward and backward;
* ``ref.chunked_attention_split``, the split route's arithmetic (float32
  partials per split, combined in split order, a split with no live key
  for a row skipped), against the reference and against the plain loop,
  including causal ``q_offset`` cases where whole splits are masked for
  some rows, and with the splits ``split_plan`` picks.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import layers as rlayers
from repro_torch import configs
from repro_torch.kernels import chunked_attention as ca
from repro_torch.kernels import ops, ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H = 2, 2
#: the tolerances of tests/test_torch_chunked_attention.py: forward
#: float32 (of max|want|), bfloat16 (one bf16 ulp), gradients through the
#: entry, the plain backward (of the largest)
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
GRAD_TOL = 1e-5
BWD_TOL = 1e-6

#: causal, tq, tk, chunk, q_offset
CASES = [
    (False, 6, 9, 4, 0),
    (True, 9, 9, 4, 0),
    (True, 5, 13, 4, 8),
    (False, 1, 5, 4, 0),
]
WIDE = (112, 160)


def _inputs(tq, tk, d, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, H, tq, d), (B, H, tk, d), (B, H, tk, d),
                     (B, H, tq, d))]
    if dtype == "bfloat16":
        out = [a.astype(ml_dtypes.bfloat16) for a in out]
    return out


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _near(got, want, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _reference(q, k, v, dout, causal, chunk, q_offset):
    def fn(q, k, v):
        return rlayers.chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                         q_offset=q_offset)
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return out, vjp(jnp.asarray(dout))


# ---------------------------------------------------------------------------
# d = 112 and d = 160
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk,chunk,q_offset", CASES)
@pytest.mark.parametrize("d", WIDE)
def test_wide_heads_forward_matches_reference(d, causal, tq, tk, chunk,
                                              q_offset, dtype):
    q, k, v, _ = _inputs(tq, tk, d, 11, dtype)
    got = ops.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                q_offset=q_offset, chunk=chunk)
    want = rlayers.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=causal, chunk=chunk,
                                     q_offset=q_offset)
    assert got.dtype == _t(q).dtype
    _near(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("causal,tq,tk,chunk,q_offset", CASES)
@pytest.mark.parametrize("d", WIDE)
def test_wide_heads_gradients_match_reference(d, causal, tq, tk, chunk,
                                              q_offset):
    q, k, v, dout = _inputs(tq, tk, d, 12)
    _, want = _reference(q, k, v, dout, causal, chunk, q_offset)
    xs = [_t(a).requires_grad_(True) for a in (q, k, v)]
    ops.chunked_attention(*xs, causal=causal, q_offset=q_offset,
                          chunk=chunk).backward(_t(dout))
    for x, w in zip(xs, want):
        _near(x.grad, w, GRAD_TOL)


@pytest.mark.parametrize("causal,tq,tk,chunk,q_offset", CASES)
@pytest.mark.parametrize("d", WIDE)
def test_wide_heads_plain_backward_matches_reference(d, causal, tq, tk,
                                                     chunk, q_offset):
    q, k, v, dout = _inputs(tq, tk, d, 13)
    out, lse = ref.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                     chunk=chunk, q_offset=q_offset,
                                     return_lse=True)
    got = ref.chunked_attention_bwd(_t(q), _t(k), _t(v), out, _t(dout), lse,
                                    causal=causal, q_offset=q_offset)
    _, want = _reference(q, k, v, dout, causal, chunk, q_offset)
    for g, w in zip(got, want):
        _near(g, w, BWD_TOL)


#: the padding invariant's tolerance (float32, of max|want|): the same
#: sums with zero terms added
PAD_TOL = 1e-6


@pytest.mark.parametrize("causal,tq,tk,chunk,q_offset", CASES)
@pytest.mark.parametrize("d", WIDE)
def test_zero_padded_width_gives_the_true_width(d, causal, tq, tk, chunk,
                                                q_offset):
    """The tile routes' layout at d 112 and 160, in float32: q, k, v and
    the cotangent zero-padded from d to whole 64-column chunks, through
    the plain loop and ``ref.chunked_attention_bwd`` with the true
    width's scale, then sliced back to d, give the unpadded output,
    log-sum-exp and gradients; the padding columns of every output are
    zero."""
    q, k, v, dout = (_t(a) for a in _inputs(tq, tk, d, 14))
    width = -(-d // 64) * 64
    assert width == {112: 128, 160: 192}[d]

    def pad(t):
        return torch.nn.functional.pad(t, (0, width - d))

    scale = 1.0 / (d ** 0.5)
    out, lse = ref.chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                     q_offset=q_offset, return_lse=True)
    p_out, p_lse = ref.chunked_attention(pad(q), pad(k), pad(v),
                                         causal=causal, chunk=chunk,
                                         q_offset=q_offset, return_lse=True,
                                         scale=scale)
    _near(p_out[..., :d], out, PAD_TOL)
    _near(p_lse, lse, PAD_TOL)
    assert not p_out[..., d:].any()
    grads = ref.chunked_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                      q_offset=q_offset)
    p_grads = ref.chunked_attention_bwd(pad(q), pad(k), pad(v), p_out,
                                        pad(dout), p_lse, causal=causal,
                                        q_offset=q_offset, scale=scale)
    for g, p in zip(grads, p_grads):
        _near(p[..., :d], g, PAD_TOL)
        assert not p[..., d:].any()


# ---------------------------------------------------------------------------
# the route plans
# ---------------------------------------------------------------------------

#: chip_smoke.py's ATTN_PATHS (B, H, Tq, Tk, d, causal) with the forward
#: and backward routes each takes in bfloat16
PATH_ROUTES = {
    "whisper-encoder": ((8, 16, 1500, 1500, 64, False), "tile", "tile"),
    "whisper-cross-prefill": ((8, 16, 512, 1500, 64, False), "tile", "tile"),
    "whisper-cross-decode": ((8, 16, 1, 1500, 64, False), "split", "tile"),
    "llama-cross-prefill": ((8, 64, 512, 1024, 128, False), "tile", "tile"),
    "llama-cross-decode": ((8, 64, 1, 1024, 128, False), "split", "tile"),
    "phi4-train": ((8, 24, 256, 256, 128, True), "tile", "tile"),
    "grok-train": ((8, 48, 256, 256, 128, True), "tile", "tile"),
    "kimi-train": ((8, 64, 256, 256, 112, True), "tile", "tile"),
    "stablelm-train": ((8, 32, 256, 256, 160, True), "tile", "tile"),
    "jamba-train": ((2, 64, 1024, 1024, 128, True), "tile", "tile"),
    "jamba-smoke-train": ((2, 4, 64, 64, 16, True), "head", "head"),
}


def _meta(b, h, tq, tk, d, dtype=torch.bfloat16):
    def f(t):
        return torch.empty((b, h, t, d), dtype=dtype, device="meta")
    return f(tq), f(tk), f(tk), f(tq)


def _plans(q, k, v, out, causal, q_offset=0):
    return (ca.attn_plan(q, k, v, causal, q_offset),
            ca.attn_bwd_plan(q, k, v, out, out, causal, q_offset))


@pytest.mark.parametrize("path", sorted(PATH_ROUTES))
def test_plan_at_the_main_paths(path):
    (b, h, tq, tk, d, causal), fwd, bwd = PATH_ROUTES[path]
    q, k, v, out = _meta(b, h, tq, tk, d)
    assert _plans(q, k, v, out, causal) == (fwd, bwd)


#: (Tq, d, dtype) -> forward and backward routes, q, k, v aligned
EDGES = [
    (1, 64, torch.float32, "simt", "simt"),
    (300, 160, torch.float32, "simt", "simt"),
    (1, 16, torch.bfloat16, "head", "head"),
    (1, 16, torch.float32, "head", "head"),
    (ca.HEAD_MAX_T, 16, torch.float32, "head", "head"),
    (ca.HEAD_MAX_T, 16, torch.bfloat16, "head", "head"),
    (ca.HEAD_MAX_T + 1, 16, torch.float32, "simt", "simt"),
    (ca.HEAD_MAX_T + 1, 16, torch.bfloat16, "mma", "mma"),
    (1, 112, torch.bfloat16, "split", "tile"),
    (1, 160, torch.bfloat16, "split", "tile"),
    (ca.SPLIT_MAX_TQ, 64, torch.bfloat16, "split", "tile"),
    (ca.SPLIT_MAX_TQ + 1, 64, torch.bfloat16, "tile", "tile"),
    (ca.SPLIT_MAX_TQ + 1, 128, torch.bfloat16, "tile", "tile"),
    (ca.SPLIT_MAX_TQ + 1, 16, torch.bfloat16, "head", "head"),
    (ca.SPLIT_MAX_TQ + 1, 112, torch.bfloat16, "tile", "tile"),
    (ca.SPLIT_MAX_TQ + 1, 160, torch.bfloat16, "tile", "tile"),
    (1500, 112, torch.bfloat16, "tile", "tile"),
    (1500, 160, torch.bfloat16, "tile", "tile"),
]


@pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 0),
                                             (True, 37)])
@pytest.mark.parametrize("tq,d,dtype,fwd,bwd", EDGES)
def test_plan_at_the_edges(tq, d, dtype, fwd, bwd, causal, q_offset):
    """The route follows the dtype, Tq, d and alignment; the mask does
    not change it."""
    q, k, v, out = _meta(2, 3, tq, 9, d, dtype)
    assert _plans(q, k, v, out, causal, q_offset) == (fwd, bwd)


def _unaligned(shape, dtype=torch.bfloat16):
    n = int(np.prod(shape))
    t = torch.zeros(n + 1, dtype=dtype)[1:].view(shape)
    assert t.data_ptr() % 16
    return t


@pytest.mark.parametrize("which", ["q", "k", "v", "out"])
@pytest.mark.parametrize("tq", [1, 64])
def test_plan_sends_an_unaligned_tensor_to_mma(which, tq):
    """TMA and the split route's 16-byte copies need 16-byte aligned
    bases; an unaligned one (the entry copies such views) goes by the
    mma route, forward or backward."""
    shapes = dict(q=(1, 2, tq, 64), k=(1, 2, 9, 64), v=(1, 2, 9, 64),
                  out=(1, 2, tq, 64))
    ts = {n: (_unaligned(s) if n == which else
              torch.zeros(s, dtype=torch.bfloat16))
          for n, s in shapes.items()}
    fwd, bwd = _plans(ts["q"], ts["k"], ts["v"], ts["out"], True)
    assert bwd == "mma"
    assert fwd == ("split" if which == "out" and tq == 1 else
                   "tile" if which == "out" else "mma")


@pytest.mark.parametrize("which", ["q", "k", "v", "out"])
@pytest.mark.parametrize("tq", [2, 300])
@pytest.mark.parametrize("d", WIDE)
def test_plan_sends_unaligned_wide_heads_to_mma(d, tq, which):
    """At d 112 and 160, as at 64: more than one query with an unaligned
    q, k or v goes by the mma route forward, and any unaligned tensor
    backward; aligned, both by tile."""
    shapes = dict(q=(1, 2, tq, d), k=(1, 2, 9, d), v=(1, 2, 9, d),
                  out=(1, 2, tq, d))
    ts = {n: (_unaligned(s) if n == which else
              torch.zeros(s, dtype=torch.bfloat16))
          for n, s in shapes.items()}
    assert _plans(ts["q"], ts["k"], ts["v"], ts["out"], True) == (
        "tile" if which == "out" else "mma", "mma")
    aligned = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes.values()]
    assert _plans(*aligned, True) == ("tile", "tile")


def _config_names():
    """Every config module under src/repro_torch/configs/."""
    d = os.path.join(ROOT, "src", "repro_torch", "configs")
    return sorted(f[:-3] for f in os.listdir(d)
                  if f.endswith(".py") and f not in ("__init__.py",
                                                     "base.py"))


def test_the_configs_are_the_assigned_ones():
    """The walk below covers every config module, and only the
    attention-free family (RWKV-6) has no attention."""
    assert sorted(configs.ASSIGNED) == _config_names()
    free = [n for n in _config_names() if configs.get(n).attention_free]
    assert free == ["rwkv6_7b"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", [n for n in _config_names()
                                  if not configs.get(n).attention_free])
def test_every_config_has_a_route(name, smoke):
    """Each config with attention (and its smoke config) has a head width
    the kernels are built for and a route forward and backward, prefill
    and decode."""
    cfg = configs.get(name)
    if smoke:
        cfg = configs.smoke(cfg)
    d = cfg.hd
    assert d in ca.HEAD_DIMS, (name, d)
    for tq in (1, 256):
        q, k, v, out = _meta(1, cfg.n_heads, tq, 256, d, cfg.torch_dtype)
        fwd, bwd = _plans(q, k, v, out, True)
        assert fwd in ca.ROUTES and bwd in ca.BWD_ROUTES
        assert "head" not in (fwd, bwd)  # 256 keys: past its limit
        if cfg.torch_dtype == torch.bfloat16:
            assert fwd == ("split" if tq <= ca.SPLIT_MAX_TQ else
                           "tile" if d in ca.TILE_HEAD_DIMS else "mma")
        else:
            assert (fwd, bwd) == ("simt", "simt")


# ---------------------------------------------------------------------------
# the head route: every attention of the smoke configs, and its limits
# ---------------------------------------------------------------------------

#: chip_smoke.py's [train-small] batch and training length (every float32
#: smoke config), and its [train-ssm] Jamba run's (the smoke config in
#: bfloat16)
SMOKE_TRAIN = dict(batch=2, seq_len=16)
JAMBA_BF16_TRAIN = dict(batch=2, seq_len=64)


def _attention_shapes(cfg, batch, seq_len):
    """The (q shape, k shape, dtype) of every chunked attention a training
    step of ``cfg``'s model runs, recorded at the entry (forward, and the
    checkpoint's recompute, through autograd on the CPU; stub memory for
    the vlm and encdec families), and the one-query decode of each (Tq =
    1 against the same keys)."""
    import types

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import value_and_grad
    seen = set()

    def record(q, k, v, **kw):
        seen.add((tuple(q.shape), tuple(k.shape), q.dtype))
        return ca.chunked_attention(q, k, v, **kw)

    model = build_model(cfg, "spec")
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                  global_batch=batch))
    b = {n: torch.from_numpy(a) for n, a in data.batch_at(0).items()}
    if cfg.family in ("vlm", "encdec"):
        n = cfg.enc_len if cfg.family == "encdec" else cfg.n_patches
        b["frames" if cfg.family == "encdec" else "patches"] = torch.randn(
            (batch, n, cfg.d_model),
            generator=torch.Generator().manual_seed(4)).to(cfg.torch_dtype)
    saved = layers.attention
    layers.attention = types.SimpleNamespace(chunked_attention=record)
    try:
        value_and_grad(model, params, b)
    finally:
        layers.attention = saved
    decode = {((qs[0], qs[1], 1, qs[3]), ks, dt) for qs, ks, dt in seen}
    return sorted(seen | decode, key=str)


def _smoke_cases():
    """Every smoke config with attention in float32 at [train-small]'s
    length, and Jamba's in bfloat16 at [train-ssm]'s."""
    cases = [(n, "float32", SMOKE_TRAIN) for n in _config_names()
             if not configs.get(n).attention_free]
    return cases + [("jamba_1_5_large_398b", "bfloat16", JAMBA_BF16_TRAIN)]


@pytest.mark.parametrize("name,dtype,train", _smoke_cases())
def test_smoke_attention_plans_to_head(name, dtype, train):
    """Self attention at the training length, the encoder, cross attention
    and each one-query decode of a smoke config: every shape its model
    gives the entry plans to ``head``, forward and backward."""
    import dataclasses
    cfg = dataclasses.replace(configs.smoke(configs.get(name)), dtype=dtype)
    shapes = _attention_shapes(cfg, **train)
    assert shapes and {dt for _, _, dt in shapes} == {cfg.torch_dtype}
    tq = {qs[2] for qs, _, _ in shapes}
    assert {1, train["seq_len"]} <= tq, tq
    if cfg.family == "encdec":
        assert any(ks[2] == cfg.enc_len for _, ks, _ in shapes)
    if cfg.family == "vlm":
        assert any(ks[2] == cfg.n_patches for _, ks, _ in shapes)
    for qs, ks, dt in shapes:
        assert qs[3] == ca.HEAD_D
        q, k, v = (torch.empty(s, dtype=dt, device="meta")
                   for s in (qs, ks, ks))
        for causal in (False, True):
            assert _plans(q, k, v, q, causal) == ("head", "head"), (qs, ks)


#: (Tq, Tk, d, dtype) past the head route's limits -> forward and
#: backward routes, as without it
PAST_HEAD = [
    (ca.HEAD_MAX_T + 1, 16, 16, torch.float32, "simt", "simt"),
    (16, ca.HEAD_MAX_T + 1, 16, torch.float32, "simt", "simt"),
    (ca.HEAD_MAX_T + 1, ca.HEAD_MAX_T + 1, 16, torch.float32, "simt",
     "simt"),
    (ca.HEAD_MAX_T + 1, 16, 16, torch.bfloat16, "mma", "mma"),
    (16, ca.HEAD_MAX_T + 1, 16, torch.bfloat16, "mma", "mma"),
    (1, ca.HEAD_MAX_T + 1, 16, torch.bfloat16, "split", "mma"),
    (16, 16, 64, torch.float32, "simt", "simt"),
    (16, 16, 64, torch.bfloat16, "tile", "tile"),
    (1, 16, 64, torch.bfloat16, "split", "tile"),
    (16, 16, 112, torch.bfloat16, "tile", "tile"),
    (16, 16, 128, torch.float32, "simt", "simt"),
    (1, 16, 160, torch.bfloat16, "split", "tile"),
]


@pytest.mark.parametrize("tq,tk,d,dtype,fwd,bwd", PAST_HEAD)
def test_plan_past_the_head_limits(tq, tk, d, dtype, fwd, bwd):
    """One query or key past :data:`HEAD_MAX_T`, or a width other than
    :data:`HEAD_D`, takes the route it took before the head route."""
    q, k, v, out = _meta(2, 4, tq, tk, d, dtype)
    for causal, q_offset in ((False, 0), (True, 37)):
        assert _plans(q, k, v, out, causal, q_offset) == (fwd, bwd)


@pytest.mark.parametrize("which", ["q", "k", "v", "out"])
def test_plan_sends_an_unaligned_head_call_elsewhere(which):
    """The head route's bulk copies need 16-byte aligned bases: an
    unaligned q, k or v sends the forward to mma, any unaligned tensor
    the backward."""
    shapes = dict(q=(1, 2, 16, 16), k=(1, 2, 9, 16), v=(1, 2, 9, 16),
                  out=(1, 2, 16, 16))
    ts = {n: (_unaligned(s) if n == which else
              torch.zeros(s, dtype=torch.bfloat16))
          for n, s in shapes.items()}
    assert _plans(ts["q"], ts["k"], ts["v"], ts["out"], True) == (
        "head" if which == "out" else "mma", "mma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_smem_within_the_limit(dtype):
    """Every head up to :data:`HEAD_MAX_T` queries and keys fits the 48 KB
    a block takes without an opt-in, so the limit on shared memory never
    narrows the route's shapes; it grows with both lengths."""
    worst = 0
    for tq in range(ca.HEAD_MAX_T + 1):
        for tk in range(1, ca.HEAD_MAX_T + 1):
            n = ca.head_smem_bytes(tq, tk, ca.HEAD_D, dtype)
            assert n <= ca.HEAD_SMEM_LIMIT, (tq, tk, n)
            assert n >= ca.head_smem_bytes(max(tq - 1, 0), tk, ca.HEAD_D,
                                           dtype)
            worst = max(worst, n)
    assert worst == ca.head_smem_bytes(ca.HEAD_MAX_T, ca.HEAD_MAX_T,
                                       ca.HEAD_D, dtype)
    assert ca.head_smem_bytes(ca.HEAD_MAX_T, ca.HEAD_MAX_T, ca.HEAD_D,
                              torch.float32) == 37648


def test_head_limits_are_the_kernel_source():
    """The module's head width, limit on queries and keys, and limit on
    shared memory are ``csrc/chunked_attention_head.cu``'s, which refuses
    what is past them."""
    import re

    from repro_torch.kernels import build
    src = (build.SRC_DIR / "chunked_attention_head.cu").read_text()

    def const(name):
        return eval(re.search(rf"constexpr int {name} = ([^;]+);",
                              src).group(1))

    assert const("kD") == ca.HEAD_D
    assert const("kMaxT") == ca.HEAD_MAX_T
    assert const("kSmemLimit") == ca.HEAD_SMEM_LIMIT


def test_split_plan_covers_the_keys():
    """Every split non-empty, the keys covered, split_keys a multiple of
    16, and enough blocks at the decode paths' shapes."""
    for bh, tq, tk in ((128, 1, 1500), (512, 1, 1024), (4, 1, 1),
                       (4, 7, 9), (4, 16, 1500), (1, 1, 100000)):
        n, keys = ca.split_plan(bh, tq, tk)
        assert keys % 16 == 0 and n >= 1
        assert (n - 1) * keys < tk <= n * keys
        assert keys >= min(ca.SPLIT_MIN_KEYS, -(-tk // 16) * 16)
    n, _ = ca.split_plan(128, 1, 1500)
    assert 128 * n >= ca.SPLIT_TARGET_BLOCKS


# ---------------------------------------------------------------------------
# the split route's arithmetic
# ---------------------------------------------------------------------------

#: causal, tq, tk, q_offset, n_splits, split_keys: whole splits masked
#: for the first rows where causal
SPLIT_CASES = [
    (False, 1, 40, 0, 5, 8),
    (False, 6, 37, 0, 3, 16),
    (True, 6, 40, 3, 5, 8),      # row 0 sees keys 0..3: splits 1-4 empty
    (True, 4, 40, 0, 10, 4),     # rows see at most 4 keys: 9 splits empty
    (True, 3, 13, 20, 2, 8),     # every key live
    (True, 1, 1, 0, 1, 16),
]


@pytest.mark.parametrize("d", [16, 64, 112])
@pytest.mark.parametrize("causal,tq,tk,q_offset,n_splits,keys", SPLIT_CASES)
def test_split_arithmetic_matches_reference_and_loop(causal, tq, tk,
                                                     q_offset, n_splits,
                                                     keys, d):
    q, k, v, _ = _inputs(tq, tk, d, 21)
    got, lse = ref.chunked_attention_split(
        _t(q), _t(k), _t(v), causal=causal, q_offset=q_offset,
        n_splits=n_splits, split_keys=keys, return_lse=True)
    want = rlayers.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=causal, chunk=512,
                                     q_offset=q_offset)
    _near(got, want, F32_TOL)
    loop, loop_lse = ref.chunked_attention(_t(q), _t(k), _t(v),
                                           causal=causal, q_offset=q_offset,
                                           chunk=4, return_lse=True)
    _near(got, loop, F32_TOL)
    _near(lse, loop_lse, F32_TOL)
    assert torch.isfinite(got).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,causal,q_offset", [(1, 1500, False, 0),
                                                   (3, 300, True, 5),
                                                   (16, 1024, True, 0)])
def test_split_arithmetic_with_the_planned_splits(tq, tk, causal, q_offset,
                                                  dtype):
    """With :func:`split_plan`'s splits the arithmetic is the loop's
    function: float32 within ``F32_TOL``, bfloat16 within one bf16 ulp
    of the reference (the split route keeps p in float32)."""
    q, k, v, _ = _inputs(tq, tk, 64, 22, dtype)
    n, keys = ca.split_plan(B * H, tq, tk)
    got = ref.chunked_attention_split(_t(q), _t(k), _t(v), causal=causal,
                                      q_offset=q_offset, n_splits=n,
                                      split_keys=keys)
    assert got.dtype == _t(q).dtype
    want = rlayers.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=causal, chunk=512,
                                     q_offset=q_offset)
    _near(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
