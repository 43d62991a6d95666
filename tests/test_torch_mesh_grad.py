"""Gradients through the MoE mesh variants, on two gloo ranks, against
the reference's ``shard_map`` variants on two host devices.

``repro_torch.models.moe``'s expert-parallel and tensor-parallel wrappers
take each input's local shard and give it back through autograd as the
transpose of a ``shard_map`` input: where every rank uses a replicated
value for its own part of the work (its experts, its slice of the FFN
width, its tokens), the local gradient is a partial sum over those
ranks.  The train step differentiates through them on a mesh (the dry
run's train cells).  Here a float32 smoke config's MoE layer runs the
expert-parallel variant (Kimi-K2's) and the tensor-parallel one
(Grok-1's; ``_moe_spec_ep`` / ``_moe_spec_tp`` called by name, as the
reference's are) on a ``(1, 2)`` mesh (two model shards: the tokens'
and the router's gradients are partial over ``model``) and a ``(2, 1)``
mesh (two data shards: the weights' gradients are partial over
``data``).  Its output and the gradient of a fixed weighting of it are
held within 1e-6 to the reference's ``jax.grad`` through its variant on
the same mesh shape (``kernel=False``, one subprocess with two forced
host devices), and to the port's flat path.  Before the wrappers
declared their local gradients partial, the tokens' and the router's
gradients on a ``(1, 2)`` mesh were one shard's part of them (up to the
whole magnitude off).
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch.mesh import free_port
from repro_torch.models import moe
from repro_torch.models.model import init_sublayer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
ARCH = {"ep": "kimi_k2_1t_a32b", "tp": "grok_1_314b"}
MESHES = ((1, 2), (2, 1))

#: the reference: argv = input npz (``_case``'s tensors), output npz
REF = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.models import moe

    ins = dict(np.load(sys.argv[1]))
    out = {}
    devs = np.array(jax.devices()[:2])
    for var, fn in (("ep", moe._moe_spec_ep), ("tp", moe._moe_spec_tp)):
        p = {k[len(var) + 3:]: jnp.asarray(v) for k, v in ins.items()
             if k.startswith(var + "_p_")}
        x, w = (jnp.asarray(ins[f"{var}_{k}"]) for k in ("x", "w"))
        kw = {k: ins[f"{var}_kw_{k}"].item() for k in
              ("n_experts", "top_k", "capacity_factor")}
        for shape in ((1, 2), (2, 1)):
            mesh = Mesh(devs.reshape(shape), ("data", "model"))

            def f(p, x):
                y = fn(p, x, mesh=mesh, kernel=False, **kw)
                return (y * w).sum(), y

            with mesh:
                (gp, gx), y = jax.jit(jax.grad(f, argnums=(0, 1),
                                               has_aux=True))(p, x)
            tag = f"{var}_{shape[0]}{shape[1]}"
            out[f"{tag}_out"] = np.asarray(y)
            out[f"{tag}_x"] = np.asarray(gx)
            out.update({f"{tag}_{k}": np.asarray(v) for k, v in gp.items()})
    np.savez(sys.argv[2], **out)
""")


def _case(var: str):
    """The layer's parameters, tokens and output weighting (seeded)."""
    cfg = base.smoke(base.get(ARCH[var]))
    g = torch.Generator().manual_seed(7)
    p = init_sublayer(cfg, "moe", g, "cpu")
    x = torch.randn(16, cfg.d_model, generator=g)
    w = torch.randn(16, cfg.d_model, generator=g)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=2.0)
    return cfg, p, x, w, kw


#: one rank: argv = mesh rows, mesh columns, output npz, rank, rendezvous
#: port, this file's directory
RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import distribute_params, process_group
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh
    sys.path.insert(0, sys.argv[6])
    from test_torch_mesh_grad import _case

    shape = (int(sys.argv[1]), int(sys.argv[2]))
    dst, rank, port = sys.argv[3], int(sys.argv[4]), sys.argv[5]
    out = {}
    with process_group("gloo", 2, rank, f"tcp://localhost:{port}"):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        rep = [Replicate(), Replicate()]
        for var in ("ep", "tp"):
            cfg, p, x, w, kw = _case(var)
            with use_mesh(mesh), implicit_replication():
                tree = {"groups": [{"s1_moe": p}]}
                pd = distribute_params(tree, cfg, mesh)["groups"][0]["s1_moe"]
                for t in pd.values():
                    t.requires_grad_(True)
                xd = DTensor.from_local(x, mesh, rep, run_check=False)
                xd.requires_grad_(True)
                fn = moe._moe_spec_ep if var == "ep" else moe._moe_spec_tp
                y = fn(pd, xd, mesh=mesh, **kw)
                (y * DTensor.from_local(w, mesh, rep,
                                        run_check=False)).sum().backward()
                out[f"{var}_out"] = y.detach().full_tensor().numpy()
                out[f"{var}_x"] = xd.grad.full_tensor().numpy()
                for k, t in pd.items():
                    if t.grad is not None:
                        out[f"{var}_{k}"] = t.grad.full_tensor().numpy()
    np.savez(dst, **out)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's results, and each mesh's: two gloo ranks in two
    subprocesses a mesh, all side by side."""
    d = tmp_path_factory.mktemp("mesh_grad")
    ins = {}
    for var in ARCH:
        _, p, x, w, kw = _case(var)
        ins.update({f"{var}_p_{k}": t.numpy() for k, t in p.items()})
        ins.update({f"{var}_x": x.numpy(), f"{var}_w": w.numpy()})
        ins.update({f"{var}_kw_{k}": np.asarray(v) for k, v in kw.items()})
    src, ref_out = str(d / "in.npz"), str(d / "ref.npz")
    np.savez(src, **ins)
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF, src, ref_out],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"))]
    outs = {}
    for shape in MESHES:
        port = str(free_port())
        outs[shape] = [str(d / f"{shape[0]}{shape[1]}_r{r}.npz")
                       for r in range(2)]
        procs += [subprocess.Popen(
            [sys.executable, "-c", RANK, str(shape[0]), str(shape[1]),
             outs[shape][r], str(r), port, os.path.dirname(__file__)],
            env=_env()) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0
    finally:
        for p in procs:
            p.kill()
    res = {shape: [dict(np.load(o)) for o in outs[shape]]
           for shape in MESHES}
    return dict(np.load(ref_out)), res


@pytest.mark.parametrize("var", ["ep", "tp"])
@pytest.mark.parametrize("shape", MESHES)
def test_variant_gradients_match_flat(ranks, shape, var):
    cfg, p, x, w, kw = _case(var)
    pf = {k: t.clone().requires_grad_(True) for k, t in p.items()}
    xf = x.clone().requires_grad_(True)
    y = moe._moe_spec_flat(pf, xf, **kw)
    (y * w).sum().backward()
    want = {"out": y.detach(), "x": xf.grad}
    want.update({k: t.grad for k, t in pf.items() if t.grad is not None})
    for res in ranks[1][shape]:
        got = {k[len(var) + 1:]: v for k, v in res.items()
               if k.startswith(var + "_")}
        assert sorted(got) == sorted(want)
        for k, t in want.items():
            np.testing.assert_allclose(got[k], t.numpy(), atol=TOL,
                                       rtol=TOL, err_msg=k)


@pytest.mark.parametrize("var", ["ep", "tp"])
@pytest.mark.parametrize("shape", MESHES)
def test_variant_gradients_match_reference(ranks, shape, var):
    """The output and every gradient (the tokens', the router's, the
    experts') within 1e-6 of ``jax.grad`` through the reference's
    variant on the same mesh shape."""
    ref, res_by_shape = ranks
    tag = f"{var}_{shape[0]}{shape[1]}_"
    want = {k[len(tag):]: v for k, v in ref.items() if k.startswith(tag)}
    for res in res_by_shape[shape]:
        got = {k[len(var) + 1:]: v for k, v in res.items()
               if k.startswith(var + "_")}
        # a parameter the layer does not read (its norm scale) has no
        # gradient here and a zero one there
        assert set(got) <= set(want)
        assert all(not want[k].any() for k in set(want) - set(got))
        for k, t in got.items():
            np.testing.assert_allclose(t, want[k], atol=TOL, rtol=TOL,
                                       err_msg=k)
