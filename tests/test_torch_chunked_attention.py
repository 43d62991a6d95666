"""The port's chunked attention (``ops.chunked_attention``,
``repro_torch.models.layers.chunked_attention``) on CPU tensors against
the reference's ``repro.models.layers.chunked_attention`` (its
``lax.scan`` over key chunks, plain JAX on the CPU), and the plain
backward that the CUDA kernels' algorithm follows.

* forward: float32 and bfloat16, causal and not, ``q_offset > 0``,
  several chunks (``chunk=4``) with Tk not a multiple of the chunk, one
  chunk, one query.  float32 within ``F32_TOL`` of max|want| (the scores'
  float32 sums run in another order in XLA's dot than in torch's
  matmul); bfloat16 within ``BF16_TOL`` of max|want|, one bf16 ulp: both
  loops round q·k, p and each chunk's product to bf16 at the same points,
  and a score that lands on the other side of a rounding boundary moves
  the output by at most that.
* gradients through the entry (autograd through the loop) against
  ``jax.vjp`` of the reference, float32, within ``GRAD_TOL`` of the
  largest.
* ``ref.chunked_attention_bwd`` (the backward kernels' algorithm: the
  probabilities recomputed from the forward's log-sum-exp, ``D =
  rowsum(dO * O)``) against autograd through the loop and against
  ``jax.vjp``, within ``BWD_TOL`` of the largest.
* the entry's checks, and that a CPU tensor runs the plain loop (bitwise,
  no launch counted).
* the shared local-shard helper (``repro_torch.models.sharding.
  local_call``) around the entry, with the layer's dimension maps (the
  path ``layers.chunked_attention`` takes on CUDA DTensors), on two gloo
  ranks, sharded on heads (a ``(1, 2)`` mesh) and on batch (``(2, 1)``),
  with k and v sharded as q or replicated (then sliced locally, their
  gradients partial sums): outputs and the gradients of q, k and v equal
  the unsharded call's within ``MESH_TOL``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import layers as rlayers
from repro_torch.kernels import chunked_attention as ca
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import free_port
from repro_torch.models import layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, D = 2, 3, 16
#: forward, float32: atol of max|want| (and rtol)
F32_TOL = 1e-5
#: forward, bfloat16: one bf16 ulp of max|want|
BF16_TOL = 2.0 ** -7
#: gradients through the entry against jax.vjp, float32: of the largest
GRAD_TOL = 1e-5
#: the plain backward against autograd and jax.vjp: of the largest
BWD_TOL = 1e-6
#: the local-shard path against the unsharded call (rtol = atol)
MESH_TOL = 1e-6

#: causal, tq, tk, chunk, q_offset
CASES = [
    (False, 6, 9, 4, 0),     # three chunks, the last partial
    (True, 9, 9, 4, 0),      # causal self-attention (training)
    (True, 5, 13, 4, 8),     # queries at the end of the keys
    (True, 7, 13, 512, 3),   # one chunk, Tk < chunk
    (False, 1, 5, 4, 0),     # one query (a decode step's cross attention)
]


def _inputs(tq, tk, seed, dtype="float32", h=H):
    """Seeded q, k, v and an output cotangent, numpy."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, h, tq, D), (B, h, tk, D), (B, h, tk, D),
                     (B, h, tq, D))]
    if dtype == "bfloat16":
        out = [a.astype(ml_dtypes.bfloat16) for a in out]
    return out


def _t(a):
    """numpy (float32 or ml_dtypes bf16) -> the same torch bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(x):
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, dtype=np.float32))


def _near(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _reference(q, k, v, dout, causal, chunk, q_offset):
    """The reference's output and, through ``jax.vjp``, the gradients of
    q, k and v given ``dout``."""
    def fn(q, k, v):
        return rlayers.chunked_attention(q, k, v, causal=causal, chunk=chunk,
                                         q_offset=q_offset)
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return out, vjp(jnp.asarray(dout))


def _port_grads(q, k, v, dout, causal, chunk, q_offset):
    xs = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.chunked_attention(*xs, causal=causal, q_offset=q_offset,
                                chunk=chunk)
    out.backward(_t(dout))
    return out, [x.grad for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk,chunk,q_offset", CASES)
def test_forward_matches_reference(causal, tq, tk, chunk, q_offset, dtype):
    q, k, v, _ = _inputs(tq, tk, 1, dtype)
    got = ops.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                q_offset=q_offset, chunk=chunk)
    want = rlayers.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=causal, chunk=chunk,
                                     q_offset=q_offset)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    _near(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("causal,tq,tk,chunk,q_offset", CASES)
def test_gradients_match_reference_grad(causal, tq, tk, chunk, q_offset):
    q, k, v, dout = _inputs(tq, tk, 2)
    _, want = _reference(q, k, v, dout, causal, chunk, q_offset)
    _, got = _port_grads(q, k, v, dout, causal, chunk, q_offset)
    for g, w in zip(got, want):
        _near(g, w, GRAD_TOL)


@pytest.mark.parametrize("causal,tq,tk,chunk,q_offset", CASES)
def test_plain_backward_matches_autograd_and_reference(causal, tq, tk, chunk,
                                                       q_offset):
    """The backward kernels' algorithm, from the loop's output and
    log-sum-exp, against autograd through the loop and ``jax.vjp``."""
    q, k, v, dout = _inputs(tq, tk, 3)
    out, lse = ref.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                     chunk=chunk, q_offset=q_offset,
                                     return_lse=True)
    got = ref.chunked_attention_bwd(_t(q), _t(k), _t(v), out, _t(dout), lse,
                                    causal=causal, q_offset=q_offset)
    _, auto = _port_grads(q, k, v, dout, causal, chunk, q_offset)
    _, want = _reference(q, k, v, dout, causal, chunk, q_offset)
    for g, a, w in zip(got, auto, want):
        assert g.dtype == torch.float32
        _near(g, a, BWD_TOL)
        _near(g, w, BWD_TOL)


def test_lse_is_the_row_log_sum_exp():
    """The statistic the backward takes: ``log sum_j exp(s_ij)`` over the
    live keys, whatever the chunk."""
    q, k, v, _ = _inputs(5, 13, 4)
    qt, kt = _t(q), _t(k)
    s = (qt @ kt.transpose(-1, -2)) / D ** 0.5
    live = torch.arange(13)[None, :] <= 8 + torch.arange(5)[:, None]
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    for chunk in (4, 512):
        _, lse = ref.chunked_attention(qt, kt, _t(v), causal=True,
                                       chunk=chunk, q_offset=8,
                                       return_lse=True)
        _near(lse, want, BWD_TOL)


@pytest.mark.parametrize("fault", ["dtype", "mixed", "heads", "width",
                                   "rank", "empty_keys", "offset", "chunk"])
def test_entry_checks_its_arguments(fault):
    q, k, v = (_t(a) for a in _inputs(4, 6, 5)[:3])
    kw = dict(causal=True, q_offset=0, chunk=512)
    if fault == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif fault == "mixed":
        v = v.to(torch.bfloat16)
    elif fault == "heads":
        k, v = k[:, :1], v[:, :1]
    elif fault == "width":
        k, v = k[..., :8], v[..., :8]
    elif fault == "rank":
        q = q[0]
    elif fault == "empty_keys":
        k, v = k[:, :, :0], v[:, :, :0]
    elif fault == "offset":
        kw["q_offset"] = -1
    else:
        kw["chunk"] = 0
    with pytest.raises((TypeError, ValueError)):
        ops.chunked_attention(q, k, v, **kw)


def test_cpu_tensors_run_the_plain_loop():
    """On CPU tensors the entry and the layer are the plain loop, bitwise,
    in both dtypes, and no launch is counted."""
    before = (ca.chunked_attention.launches,
              ca.chunked_attention.bwd_launches)
    for dtype in ("float32", "bfloat16"):
        q, k, v, _ = (_t(a) for a in _inputs(7, 11, 6, dtype))
        want = ref.chunked_attention(q, k, v, causal=True, chunk=4,
                                     q_offset=4)
        for fn in (ops.chunked_attention, layers.chunked_attention):
            got = fn(q, k, v, causal=True, chunk=4, q_offset=4)
            assert torch.equal(got, want)
    assert (ca.chunked_attention.launches,
            ca.chunked_attention.bwd_launches) == before


# ---------------------------------------------------------------------------
# the local-shard helper on two gloo ranks
# ---------------------------------------------------------------------------

MESHES = ((1, 2), (2, 1))
#: k and v placed as q is (heads or batch rows sharded), or replicated
KV_PLACES = ("sharded", "replicated")

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import process_group
    from repro_torch.models import layers, sharding

    shape = (int(sys.argv[1]), int(sys.argv[2]))
    dst, rank, port = sys.argv[3], int(sys.argv[4]), sys.argv[5]
    data = dict(np.load(sys.argv[6]))
    out = {}
    with process_group("gloo", 2, rank, f"tcp://localhost:{port}"):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        # batch rows over data, heads over model
        pl = [Shard(0), Shard(1)]
        rep = [Replicate(), Replicate()]
        for kv in ("sharded", "replicated"):
            xs = []
            for i, name in enumerate(("q", "k", "v")):
                t = DTensor.from_local(torch.from_numpy(data[name]), mesh,
                                       rep, run_check=False)
                if i == 0 or kv == "sharded":
                    t = t.redistribute(mesh, pl)
                xs.append(t.detach().requires_grad_(True))
            o = sharding.local_call(
                lambda q, k, v: ops.chunked_attention(
                    q, k, v, causal=True, chunk=4, q_offset=2),
                xs, layers._ATTN_DIMS)
            assert list(o.placements) == pl
            w = DTensor.from_local(torch.from_numpy(data["dout"]), mesh, rep,
                                   run_check=False)
            (o * w).sum().backward()
            out[f"{kv}_out"] = o.detach().full_tensor().numpy()
            for name, t in zip("qkv", xs):
                out[f"{kv}_d{name}"] = t.grad.full_tensor().numpy()
    np.savez(dst, **out)
""")


def _mesh_inputs():
    """Four heads, so that either mesh divides the sharded dimension."""
    q, k, v, dout = _inputs(6, 9, 7, h=4)
    return dict(q=q, k=k, v=v, dout=dout)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("attn_mesh")
    data = str(d / "inputs.npz")
    np.savez(data, **_mesh_inputs())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    procs, outs = [], {}
    for shape in MESHES:
        port = str(free_port())
        outs[shape] = [str(d / f"{shape[0]}{shape[1]}_r{r}.npz")
                       for r in range(2)]
        procs += [subprocess.Popen(
            [sys.executable, "-c", RANK, str(shape[0]), str(shape[1]),
             outs[shape][r], str(r), port, data], env=env)
            for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0
    finally:
        for p in procs:
            p.kill()
    return {shape: [dict(np.load(o)) for o in outs[shape]]
            for shape in MESHES}


@pytest.mark.parametrize("kv", KV_PLACES)
@pytest.mark.parametrize("shape", MESHES)
def test_local_shards_give_the_unsharded_attention(mesh_runs, shape, kv):
    data = _mesh_inputs()
    xs = [torch.from_numpy(data[n]).requires_grad_(True) for n in "qkv"]
    out = layers.chunked_attention(*xs, causal=True, chunk=4, q_offset=2)
    (out * torch.from_numpy(data["dout"])).sum().backward()
    for res in mesh_runs[shape]:
        np.testing.assert_allclose(res[f"{kv}_out"], out.detach().numpy(),
                                   rtol=MESH_TOL, atol=MESH_TOL)
        for name, x in zip("qkv", xs):
            np.testing.assert_allclose(res[f"{kv}_d{name}"], x.grad.numpy(),
                                       rtol=MESH_TOL, atol=MESH_TOL,
                                       err_msg=name)
