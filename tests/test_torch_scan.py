"""The SSM scans of the port (``ops.rwkv6_scan``, ``ops.mamba_scan``) on
CPU tensors against the reference's ``lax.scan`` inside its
``rwkv6_block`` and ``mamba_block``, on the CPU.

* forward: each reference block runs on seeded inputs with
  ``jax.lax.scan`` recording its arguments and results; the port's scan
  takes the same inputs (the recorded time-major ``xs`` made batch-major,
  the first state, and the ``u`` or ``A`` the step closes over), in
  float32 and bfloat16, at T = 1, at odd T and from a carried non-zero
  state.  bfloat16 outputs are the reference's **bit for bit** (the
  plain loops round where XLA's step rounds).  float32 outputs are held
  to ``rtol = atol = 1e-5``: the read-out's float32 sum runs in another
  order in XLA's dot than in torch's matmul.  The last states are held
  to ``rtol = atol = 1e-6``: XLA contracts the state update into a fused
  multiply-add on the CPU, and Mamba's float32 ``exp`` may differ in its
  last bit.  (Where the decay's product is exact the states are bitwise:
  ``tests/test_torch_ssm.py``'s ``test_scan_casts_match_reference_
  bitwise``, whose blocks run these scans.)
* gradients: on CPU tensors the scans' gradient is autograd's through
  the plain loops, the yardstick the CUDA backward kernels are held to
  on the card (``tests/test_torch_cuda.py``).  Here it is held to
  ``jax.grad`` of the reference's block, in float32 at ``1e-4``: the
  gradients of all six scan inputs reach the block's parameters (r, k, v
  and w through their projections, u and A as parameters) and its
  carried state;
* the wrappers' checks (dtype, shape, contiguity, T >= 1);
* the local-shard path (``repro_torch.models.sharding.local_call``) on two
  gloo ranks, on ``(1, 2)`` and ``(2, 1)`` ``("data", "model")`` meshes:
  heads or channels over ``model``, batch rows over ``data``, the
  replicated inputs sliced locally; outputs, last states and the
  gradients of all six inputs equal the flat scan's: the states bitwise;
  the outputs and gradients within ``rtol = atol = 1e-5`` (torch's CPU
  matmul sums the read-out in another order for fewer batch rows, and a
  replicated input's gradient, Mamba's delta's up to 70 here, is the sum
  of the ranks' partial sums).
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

from repro.models import ssm as rssm
from repro_torch.kernels import ops, scan
from repro_torch.launch.mesh import free_port
from repro_torch.models import ssm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D, HD, N = 2, 64, 16, 16
H = D // HD
#: gradients, float32: rtol = atol
GRAD_TOL = 1e-4
#: the mesh case's gradients: rtol = atol
MESH_TOL = 1e-5
#: float32 outputs against the reference's: rtol = atol
F32_TOL = 1e-5
#: last states against the reference's: rtol = atol
STATE_TOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    """numpy (float32 or ml_dtypes bf16) -> the same torch bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x):
    """A torch or jax array as numpy bits, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _params(kind, rng, dtype):
    """Seeded block parameters; ``a_log`` stays float32, as the model
    keeps it."""
    if kind == "rwkv":
        p = {"mu": rng.random((4, D)).astype(np.float32),
             "wr": _randn(rng, D, D, scale=0.2),
             "wk": _randn(rng, D, D, scale=0.2),
             "wv": _randn(rng, D, D, scale=0.2),
             "ww": _randn(rng, D, D, scale=0.1),
             "w_bias": _randn(rng, D, scale=0.5) + 1.0,
             "u": _randn(rng, D, scale=0.5),
             "wo": _randn(rng, D, D, scale=0.1)}
    else:
        p = {"in_proj": _randn(rng, D, D, scale=0.2),
             "gate_proj": _randn(rng, D, D, scale=0.1),
             "dt_proj": _randn(rng, D, scale=0.1),
             "b_proj": _randn(rng, D, N, scale=0.2),
             "c_proj": _randn(rng, D, N, scale=0.2),
             "a_log": _randn(rng, D, N, scale=0.5),
             "out_proj": _randn(rng, D, D, scale=0.1)}
    return {k: v if k == "a_log" or dtype == "float32"
            else v.astype(ml_dtypes.bfloat16) for k, v in p.items()}


def _state(kind, rng, carried):
    """The reference block's state argument: zeros or seeded."""
    scale = 0.3 if carried else 0.0
    if kind == "rwkv":
        return (jnp.asarray(_randn(rng, B, H, HD, HD, scale=scale)),
                jnp.asarray(_randn(rng, B, D)))
    return jnp.asarray(_randn(rng, B, D, N, scale=scale))


def _block(kind, params, x, state):
    if kind == "rwkv":
        return rssm.rwkv6_block(params, x, n_heads=H, head_dim=HD,
                                state=state, return_state=True)
    return rssm.mamba_block(params, x, d_state=N, state=state,
                            return_state=True)


def _recorded_scan(kind, dtype, t, carried, seed, monkeypatch):
    """The reference block's ``lax.scan``: (the port's six scan inputs,
    the reference's last state and outputs, batch-major)."""
    rng = _rng(seed)
    params = {k: jnp.asarray(v) for k, v in
              _params(kind, rng, dtype).items()}
    x = _randn(rng, B, t, D)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    state = _state(kind, rng, carried)
    calls = []
    real = jax.lax.scan

    def recording(f, init, xs, *args, **kw):
        carry, ys = real(f, init, xs, *args, **kw)
        calls.append((f, init, xs, carry, ys))
        return carry, ys

    monkeypatch.setattr(jax.lax, "scan", recording)
    _block(kind, params, jnp.asarray(x), state)
    monkeypatch.undo()
    (step, init, xs, carry, ys), = calls
    closed = dict(zip(step.__code__.co_freevars,
                      (c.cell_contents for c in step.__closure__)))
    const = closed["u" if kind == "rwkv" else "a"]
    # time-major -> batch-major
    xs = [np.swapaxes(np.asarray(a), 0, 1) for a in xs]
    ins = [_t(a) for a in xs] + [_t(np.asarray(const)), _t(np.asarray(init))]
    return ins, carry, np.swapaxes(np.asarray(ys), 0, 1)


#: (T, carried state): one token (decode), an odd prompt, a carried state
CASES = [(1, False), (1, True), (7, False), (9, True)]


@pytest.mark.parametrize("t,carried", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_scan_matches_reference_scan(kind, dtype, t, carried, monkeypatch):
    ins, carry, ys = _recorded_scan(kind, dtype, t, carried, 11 + t,
                                    monkeypatch)
    fn = ops.rwkv6_scan if kind == "rwkv" else ops.mamba_scan
    s, y = fn(*ins)
    want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    assert y.dtype == want_dtype and s.dtype == torch.float32
    assert tuple(y.shape) == ys.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_bits(y), _bits(ys))
    else:
        np.testing.assert_allclose(y.numpy(), ys, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(carry), rtol=STATE_TOL,
                               atol=STATE_TOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_scan_gradients_match_reference_grad(kind, carried):
    """float32: ``jax.grad`` of a seeded weighting of the reference
    block's outputs and last state, with respect to every parameter, the
    input and the carried state, against autograd through the port's
    block (whose scan is ``ops``' on CPU tensors)."""
    rng = _rng(21)
    raw = _params(kind, rng, "float32")
    x = _randn(rng, B, 9, D)
    jstate = _state(kind, rng, carried)
    w_y = _randn(rng, B, 9, D)
    leaves = jax.tree.leaves(jstate)
    w_s = [_randn(rng, *np.shape(a)) for a in leaves]

    def ref_loss(p, x, st):
        y, st_out = _block(kind, p, x, st)
        out = (y * w_y).sum()
        for a, w in zip(jax.tree.leaves(st_out), w_s):
            out = out + (a.astype(jnp.float32) * w).sum()
        return out

    jp = {k: jnp.asarray(v) for k, v in raw.items()}
    gp, gx, gs = jax.grad(ref_loss, argnums=(0, 1, 2))(jp, jnp.asarray(x),
                                                      jstate)
    tp = {k: _t(v).requires_grad_(True) for k, v in raw.items()}
    tx = _t(x).requires_grad_(True)
    tstate = [_t(np.asarray(a)).requires_grad_(True) for a in leaves]
    st = tuple(tstate) if kind == "rwkv" else tstate[0]
    if kind == "rwkv":
        y, st_out = ssm.rwkv6_block(tp, tx, n_heads=H, head_dim=HD,
                                    state=st, return_state=True)
        outs = list(st_out)
    else:
        y, st_out = ssm.mamba_block(tp, tx, d_state=N, state=st,
                                    return_state=True)
        outs = [st_out]
    loss = (y * _t(w_y)).sum() + sum((a.float() * _t(w)).sum()
                                     for a, w in zip(outs, w_s))
    loss.backward()
    for k, g in gp.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    for got, want in zip(tstate, jax.tree.leaves(gs)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def _scan_inputs(kind, t, dtype=torch.float32, seed=3):
    g = torch.Generator().manual_seed(seed)

    def f(*shape, lo=None):
        x = torch.randn(shape, generator=g)
        return (torch.sigmoid(x + 2) if lo else x).to(dtype)

    if kind == "rwkv":
        return [f(B, t, H, HD), f(B, t, H, HD), f(B, t, H, HD),
                f(B, t, H, HD, lo=True), f(H, HD),
                torch.randn(B, H, HD, HD, generator=g) * 0.1]
    return [f(B, t, D), torch.nn.functional.softplus(f(B, t, 1)), f(B, t, N),
            f(B, t, N), -torch.rand(D, N, generator=g),
            torch.randn(B, D, N, generator=g) * 0.1]


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
@pytest.mark.parametrize("fault", ["dtype", "state_dtype", "shape",
                                   "strided", "empty"])
def test_scan_checks_its_arguments(kind, fault):
    fn = ops.rwkv6_scan if kind == "rwkv" else ops.mamba_scan
    args = _scan_inputs(kind, 0 if fault == "empty" else 5)
    if fault == "dtype":
        args[1] = args[1].to(torch.float16)
    elif fault == "state_dtype":
        args[5] = args[5].to(torch.bfloat16)
    elif fault == "shape":
        args[4] = args[4][1:]
    elif fault == "strided":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
def test_scan_on_cpu_is_the_plain_loop(kind):
    """A CPU tensor runs the plain version: bitwise, no launch counted."""
    from repro_torch.kernels import ref
    fn, plain, wrapper = ((ops.rwkv6_scan, ref.rwkv6_scan, scan.rwkv6_scan)
                          if kind == "rwkv" else
                          (ops.mamba_scan, ref.mamba_scan, scan.mamba_scan))
    args = _scan_inputs(kind, 6, torch.bfloat16)
    before = (wrapper.launches, wrapper.bwd_launches)
    for got, want in zip(fn(*args), plain(*args)):
        assert torch.equal(got, want)
    assert (wrapper.launches, wrapper.bwd_launches) == before


# ---------------------------------------------------------------------------
# the local-shard path on two gloo ranks
# ---------------------------------------------------------------------------

#: where each input lies on a ("data", "model") mesh: a tensor dimension
#: (or None) per mesh axis, as the model places them (heads or channels on
#: model, batch rows on data; Mamba's delta, B, C and A replicated over
#: model; the first state a plain zero tensor or sharded like the model's)
PLACES = {
    "rwkv": [(0, 2)] * 4 + [(None, 0), (0, 1)],
    "mamba": [(0, 2), (0, None), (0, None), (0, None), (None, None),
              (0, 1)],
}
MESHES = ((1, 2), (2, 1))

RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import process_group
    from repro_torch.models import ssm
    sys.path.insert(0, sys.argv[5])
    from test_torch_scan import PLACES, _mesh_case

    shape = (int(sys.argv[1]), int(sys.argv[2]))
    dst, rank, port = sys.argv[3], int(sys.argv[4]), sys.argv[6]
    out = {}
    with process_group("gloo", 2, rank, f"tcp://localhost:{port}"):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for kind in ("rwkv", "mamba"):
            for plain_state in (False, True):
                args, w_s, w_y = _mesh_case(kind)
                dts = []
                for i, (a, where) in enumerate(zip(args, PLACES[kind])):
                    if i == 5 and plain_state:
                        dts.append(torch.zeros_like(a))
                        continue
                    pl = [Replicate() if d is None else Shard(d)
                          for d in where]
                    t = DTensor.from_local(a, mesh, [Replicate()] * 2,
                                           run_check=False)
                    dts.append(t.redistribute(mesh, pl).detach()
                               .requires_grad_(True))
                fn = ssm._rwkv6_scan if kind == "rwkv" else ssm._mamba_scan
                s, y = fn(*dts)
                rep = [Replicate()] * 2
                wy = DTensor.from_local(w_y, mesh, rep, run_check=False)
                ws = DTensor.from_local(w_s, mesh, rep, run_check=False)
                ((y.float() * wy).sum() + (s * ws).sum()).backward()
                tag = f"{kind}_{int(plain_state)}"
                out[f"{tag}_y"] = y.detach().full_tensor().float().numpy()
                out[f"{tag}_s"] = s.detach().full_tensor().numpy()
                for i, t in enumerate(dts):
                    if isinstance(t, DTensor):
                        out[f"{tag}_g{i}"] = t.grad.full_tensor().numpy()
    np.savez(dst, **out)
""")


def _mesh_case(kind):
    """The scan's inputs (T = 5, seeded, batch 2, four heads or 64
    channels) and the weightings of its last state and outputs."""
    args = _scan_inputs(kind, 5, seed=8)
    g = torch.Generator().manual_seed(9)
    s_shape = args[5].shape
    y_shape = args[0].shape
    return args, torch.randn(s_shape, generator=g), torch.randn(y_shape,
                                                                generator=g)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan_mesh")
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
             outs[shape][r], str(r), os.path.dirname(__file__), port],
            env=env) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0
    finally:
        for p in procs:
            p.kill()
    return {shape: [dict(np.load(o)) for o in outs[shape]]
            for shape in MESHES}


@pytest.mark.parametrize("plain_state", [False, True])
@pytest.mark.parametrize("kind", ["rwkv", "mamba"])
@pytest.mark.parametrize("shape", MESHES)
def test_local_shards_give_the_flat_scan(mesh_runs, shape, kind,
                                         plain_state):
    args, w_s, w_y = _mesh_case(kind)
    flat = [a.clone().requires_grad_(not (i == 5 and plain_state))
            for i, a in enumerate(args)]
    if plain_state:
        flat[5] = torch.zeros_like(flat[5])
    fn = ssm._rwkv6_scan if kind == "rwkv" else ssm._mamba_scan
    s, y = fn(*flat)
    ((y.float() * w_y).sum() + (s * w_s).sum()).backward()
    tag = f"{kind}_{int(plain_state)}"
    for res in mesh_runs[shape]:
        np.testing.assert_allclose(res[f"{tag}_y"], y.detach().numpy(),
                                   rtol=MESH_TOL, atol=MESH_TOL)
        np.testing.assert_array_equal(res[f"{tag}_s"], s.detach().numpy())
        grads = {int(k[len(tag) + 2:]) for k in res if
                 k.startswith(f"{tag}_g")}
        assert grads == {i for i, a in enumerate(flat) if a.requires_grad}
        for i in grads:
            np.testing.assert_allclose(res[f"{tag}_g{i}"],
                                       flat[i].grad.numpy(), rtol=MESH_TOL,
                                       atol=MESH_TOL, err_msg=str(i))
