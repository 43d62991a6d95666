"""The sharded train step on two gloo ranks, against the reference's on
two host devices.

The train step under a mesh (``value_and_grad`` through the sharding
constraints, whose backward pins each cotangent to its input's
placements, the row-parallel reductions, the vocabulary-parallel
embedding and loss, the MoE wrappers' partial gradients, the gradients
placed like their parameters, and the optimizers' sharded updates) is
the dry run's train cells' program.  Here it runs for real: float32
smoke configs on a ``(1, 2)`` ``("data", "model")`` mesh (tensor
parallel: the vocabulary, the heads and the MoE shard over ``model``)
and a ``(2, 1)`` mesh (data parallel with FSDP: the batch and the
weights shard over ``data``), each on two gloo ranks in two
subprocesses, its parameters placed by ``param_spec`` with FSDP where
the whole config takes it (``distribute_params``) and its optimizer
state placed the same way, as the dry run places both:

* Phi-4-mini: the dense step, AdamW;
* RWKV-6: the SSM step (heads sharded like the states), AdamW;
* Grok-1: the MoE step with Adafactor, its smoke config's 4 experts
  expert-parallel on ``model``, and with 3 experts tensor-parallel (the
  full config's 8 experts on 16 shards);
* Llama-3.2-Vision with one K/V head: on ``(1, 2)`` each rank holds half
  of the head's columns in each cross sublayer, and the two halves are
  exchanged by an all-to-all (``layers.kv_heads``; the full config's 8
  K/V heads on 16 shards), AdamW.

The reference runs ``jax.jit(jax.value_and_grad(model.loss))`` and one
optimizer update on the same parameters and tokens, in one subprocess
with two forced host devices, on the same mesh shapes (its parameters
placed by its ``param_spec``).  The loss, every gradient leaf and every
updated parameter are held to the reference's within 1e-6 (``rtol`` and
``atol``); for the dense, SSM and VLM configs also to the port's unsharded
step (the MoE's capacity is per data shard, in both packages, so its
unsharded step routes differently on a ``(2, 1)`` mesh).
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch.mesh import free_port
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import build_model
from repro_torch.optim.tree import map_parts
from repro_torch.train.train_step import make_optimizer, value_and_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
MESHES = ((1, 2), (2, 1))
#: case -> (arch, smoke config overrides)
CASES = {"phi4": ("phi4_mini_3_8b", {}), "rwkv6": ("rwkv6_7b", {}),
         "grok_ep": ("grok_1_314b", {}),
         "grok_tp": ("grok_1_314b", {"n_experts": 3}),
         "llama_v": ("llama_3_2_vision_90b", {"n_kv_heads": 1})}
CONFIG = """
    import dataclasses
    import numpy as np

    def config(arch, overrides):
        return dataclasses.replace(base.smoke(base.get(arch)), **overrides)

    def batch(cfg):
        rng = np.random.default_rng(5)
        out = {"tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(
            np.int32)}
        if cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (4, cfg.n_patches, cfg.d_model)).astype(np.float32)
        return out
"""

REF = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import base
    from repro.launch import mesh as mesh_mod
    from repro.models.model import build_model
    from repro.train.train_step import make_optimizer
""") + textwrap.dedent(CONFIG) + textwrap.dedent("""
    cases = json.loads(sys.argv[2])
    devs = np.array(jax.devices()[:2])
    out = {}
    for name, (arch, over) in cases.items():
        cfg = config(arch, over)
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(0))
        data = batch(cfg)
        (opt_init, opt_update), _ = make_optimizer(base.get(arch))
        res = {"params": jax.tree.map(np.asarray, params), "batch": data}
        for shape in ((1, 2), (2, 1)):
            mesh = Mesh(devs.reshape(shape), ("data", "model"))
            with mesh:
                psh = mesh_mod.shard_pytree_specs(
                    jax.eval_shape(lambda: params), cfg, mesh, False)
                bsh = {k: NamedSharding(mesh, P("data")) for k in data}
                loss, grads = jax.jit(jax.value_and_grad(m.loss),
                                      in_shardings=(psh, bsh))(params, data)
                new, _ = jax.jit(opt_update)(grads, opt_init(params),
                                             params)
            res[shape] = {"loss": float(loss),
                          "grads": jax.tree.map(np.asarray, grads),
                          "new": jax.tree.map(np.asarray, new)}
        out[name] = res
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
""")

#: one rank: argv = pickle in, pickle out, rank, rendezvous port, mesh
#: rows, mesh columns
PORT = textwrap.dedent("""
    import pickle, sys
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import base
    from repro_torch.launch.mesh import (distribute_params, needs_fsdp,
                                         process_group)
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.model import build_model
    from repro_torch.models.sharding import use_mesh
    from repro_torch.optim.tree import map_parts
    from repro_torch.train.train_step import make_optimizer, value_and_grad
""") + textwrap.dedent(CONFIG) + textwrap.dedent("""
    src, dst, rank, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
        sys.argv[4]
    shape = (int(sys.argv[5]), int(sys.argv[6]))
    with open(src, "rb") as fh:
        refs = pickle.load(fh)

    def whole(tree):
        return params_to_numpy(map_parts(
            lambda path, group, t: t.full_tensor(), tree))

    out = {}
    with process_group("gloo", 2, rank, f"tcp://localhost:{port}"):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        # plain tensors made inside the step (positions, masks) take part
        # as replicated values, as the dry run runs it
        with use_mesh(mesh), implicit_replication():
            for name, ref in refs.items():
                arch, over = ref["case"]
                cfg = config(arch, over)
                fsdp = needs_fsdp(base.get(arch))
                params = distribute_params(params_from_numpy(ref["params"]),
                                           cfg, mesh, fsdp)
                (opt_init, opt_update), _ = make_optimizer(base.get(arch))
                # the optimizer state placed by the parameters' rules on
                # its own paths, as the dry run places it
                opt = distribute_params(
                    opt_init(params_from_numpy(ref["params"])), cfg, mesh,
                    fsdp)
                data = {k: DTensor.from_local(
                    torch.from_numpy(v), mesh, [Replicate(), Replicate()],
                    run_check=False).redistribute(mesh, [Shard(0),
                                                         Replicate()])
                    for k, v in ref["batch"].items()}
                loss, grads = value_and_grad(build_model(cfg), params, data)
                new, _ = opt_update(grads, opt, params)
                out[name] = {"loss": float(loss.full_tensor()),
                             "grads": whole(grads), "new": whole(new)}
    with open(dst, "wb") as fh:
        pickle.dump(out, fh)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _config(case: str):
    ns = {}
    exec("from repro_torch.configs import base\n" + textwrap.dedent(CONFIG),
         ns)
    return ns["config"](*CASES[case])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two-device runs, then the port's two gloo ranks on
    each mesh (the two meshes' ranks side by side) on the reference's
    parameters and tokens."""
    d = tmp_path_factory.mktemp("train_mesh")
    src = str(d / "ref.pkl")
    subprocess.run([sys.executable, "-c", REF, src, json.dumps(CASES)],
                   check=True, timeout=300,
                   env=_env(JAX_PLATFORMS="cpu",
                            XLA_FLAGS="--xla_force_host_platform_device_"
                                      "count=2"))
    with open(src, "rb") as fh:
        ref = pickle.load(fh)
    ins = str(d / "in.pkl")
    with open(ins, "wb") as fh:
        pickle.dump({name: {"case": CASES[name], "params": r["params"],
                            "batch": r["batch"]}
                     for name, r in ref.items()}, fh)
    procs = {}
    for shape in MESHES:
        port = str(free_port())
        for r in range(2):
            procs[shape, r] = subprocess.Popen(
                [sys.executable, "-c", PORT, ins,
                 str(d / f"{shape[0]}{shape[1]}_r{r}.pkl"), str(r), port,
                 str(shape[0]), str(shape[1])], env=_env())
    try:
        for p in procs.values():
            assert p.wait(timeout=300) == 0
    finally:
        for p in procs.values():
            p.kill()
    ranks = {}
    for shape, r in procs:
        with open(str(d / f"{shape[0]}{shape[1]}_r{r}.pkl"), "rb") as fh:
            ranks.setdefault(shape, []).append(pickle.load(fh))
    return ref, ranks


@pytest.fixture(scope="module")
def flat(runs):
    """The port's unsharded step on the same parameters and batch, for
    the dense, SSM and VLM cases."""
    out = {}
    for case in ("phi4", "rwkv6", "llama_v"):
        ref = runs[0][case]
        params = params_from_numpy(ref["params"])
        loss, grads = value_and_grad(
            build_model(_config(case)), params,
            {k: torch.from_numpy(v) for k, v in ref["batch"].items()})
        (opt_init, opt_update), _ = make_optimizer(base.get(CASES[case][0]))
        new, _ = opt_update(grads, opt_init(params), params)
        out[case] = {"loss": float(loss), "grads": params_to_numpy(grads),
                     "new": params_to_numpy(new)}
    return out


def _leaves(tree):
    """``(key path, array)`` of a tree in the reference's layout (groups
    stacked, as ``params_to_numpy`` gives it), keys sorted."""
    out = []
    map_parts(lambda path, group, a: out.append(("/".join(path), a)), tree)
    return out


def _check(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, path)
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("shape", MESHES, ids=["tp", "dp"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(runs, flat, case, shape):
    ref, ranks = runs
    for res in ranks[shape]:
        np.testing.assert_allclose(res[case]["loss"], ref[case][shape]["loss"],
                                   rtol=TOL, atol=TOL)
        if case in flat:
            np.testing.assert_allclose(res[case]["loss"],
                                       flat[case]["loss"], rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("what", ["grads", "new"])
@pytest.mark.parametrize("shape", MESHES, ids=["tp", "dp"])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_and_update_match_reference(runs, flat, case, shape, what):
    """Every gradient leaf (``grads``) and every parameter after one
    optimizer update (``new``), gathered, on both ranks."""
    ref, ranks = runs
    want = ref[case][shape][what]
    for res in ranks[shape]:
        _check(res[case][what], want, f"{case} {shape} {what} vs reference")
        if case in flat:
            _check(res[case][what], flat[case][what],
                   f"{case} {shape} {what} vs unsharded")
