"""The port's mesh variants of speculative MoE dispatch against the
reference's, on the CPU.

``repro_torch.models.moe``'s expert-parallel and tensor-parallel variants
(``_moe_spec_ep`` / ``_moe_spec_tp``, picked by ``moe_spec`` under
``use_mesh``) are held to ``repro.models.moe``'s on the smoke Kimi-K2
config, with ``kernel=True`` and ``kernel=False``, at capacity factors
1.25 and 0.5 (the second poisons), on a ``(1, 1)`` and a ``(1, 2)``
``("data", "model")`` mesh.  The reference runs once, in one subprocess
with two forced host devices (``jax.sharding.Mesh`` of each shape); its
mesh variants run with ``kernel=False`` only, which its own tests
(``tests/test_moe_serve.py``) hold bitwise equal to ``kernel=True``; the
port runs its ``(1, 1)`` cases in this process on a one-rank gloo group
and its ``(1, 2)`` cases on two gloo ranks in two subprocesses.  Poison
counts and slot tables are compared bitwise (the reference's per-shard
slot table is its flat table read on each shard: a request's home shard
sees the flat arrival order, with local expert indices; a request
homed elsewhere is -1); outputs within 1e-6, the tolerance of
``tests/test_moe_serve.py``.
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
from repro_torch.launch.mesh import free_port, process_group
from repro_torch.models import moe
from repro_torch.models.sharding import use_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = base.smoke(base.get("kimi_k2_1t_a32b"))
CFS = (1.25, 0.5)
KERNELS = (False, True)
TOL = 1e-6

REF = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import base
    from repro.models import moe
    from repro.models.model import build_model

    cfg = base.smoke(base.get("kimi_k2_1t_a32b"))
    groups = build_model(cfg).init(jax.random.PRNGKey(0))["groups"]
    p = jax.tree.map(lambda a: a[0], groups)["s1_moe"]
    x = jax.random.normal(jax.random.PRNGKey(1), (64, cfg.d_model),
                          jnp.float32)
    out = {"x": np.asarray(x)}
    out.update({"p_" + k: np.asarray(v) for k, v in p.items()})
    devs = np.array(jax.devices())
    meshes = {"11": Mesh(devs[:1].reshape(1, 1), ("data", "model")),
              "12": Mesh(devs[:2].reshape(1, 2), ("data", "model"))}
    for cf in (1.25, 0.5):
        kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
                  capacity_factor=cf)
        logits = jnp.einsum("nd,de->ne", x, p["router"])
        gates, experts = jax.lax.top_k(
            jax.nn.softmax(logits.astype(jnp.float32), axis=-1), cfg.top_k)
        cap = moe.round_capacity(x.shape[0], cfg.n_experts, cfg.top_k, cf)
        slot, _ = moe.spec_dispatch_indices(gates, experts, cap,
                                            cfg.n_experts)
        out[f"slot_{cf}"] = np.asarray(slot).reshape(-1)
        out[f"experts_{cf}"] = np.asarray(experts).reshape(-1)
        out[f"cap_{cf}"] = cap
        for kernel in (False, True):
            o, n = moe._moe_spec_flat(p, x, kernel=kernel, stats=True, **kw)
            out[f"flat_{cf}_{kernel}"] = np.asarray(o)
            out[f"flat_n_{cf}_{kernel}"] = int(n)
        for name, mesh in meshes.items():
            for var, fn in (("ep", moe._moe_spec_ep),
                            ("tp", moe._moe_spec_tp)):
                with mesh:
                    o, n = fn(p, x, mesh=mesh, stats=True, **kw)
                out[f"{var}{name}_{cf}"] = np.asarray(o)
                out[f"{var}{name}_n_{cf}"] = int(n)
    np.savez(sys.argv[1], **out)
""")

#: one rank of the port's (1, 2) run: argv = npz in, npz out, rank, port
PORT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import base
    from repro_torch.launch.mesh import process_group
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh

    src, dst, rank, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
        sys.argv[4]
    cfg = base.smoke(base.get("kimi_k2_1t_a32b"))
    ref = np.load(src)
    p = {k[2:]: torch.from_numpy(ref[k]) for k in ref.files
         if k.startswith("p_")}
    x = torch.from_numpy(ref["x"])
    out = {}
    with process_group("gloo", 2, rank, f"tcp://localhost:{port}"):
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        shard = mesh.get_local_rank("model")
        for cf in (1.25, 0.5):
            kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
                      capacity_factor=cf)
            for kernel in (False, True):
                for var, fn in (("ep", moe._moe_spec_ep),
                                ("tp", moe._moe_spec_tp)):
                    o, n = fn(p, x, mesh=mesh, kernel=kernel, stats=True,
                              **kw)
                    out[f"{var}_{cf}_{kernel}"] = o.numpy()
                    out[f"{var}_n_{cf}_{kernel}"] = int(n)
                w = {k: moe._local(p[k], mesh, ("model", None, None))
                     for k in ("w_gate", "w_up", "w_down")}
                _, slot = moe._ep_local(p["router"], w["w_gate"],
                                        w["w_up"], w["w_down"], x, shard,
                                        kernel=kernel, **kw)
                out[f"ep_slot_{cf}_{kernel}"] = slot.numpy()
                f = (None, None, "model")
                _, flat, _ = moe._tp_local(
                    p["router"], moe._local(p["w_gate"], mesh, f),
                    moe._local(p["w_up"], mesh, f),
                    moe._local(p["w_down"], mesh, (None, "model", None)),
                    x, kernel=kernel, **kw)
                out[f"tp_slot_{cf}_{kernel}"] = flat.numpy()
            with use_mesh(mesh):
                o, n = moe.moe_spec(p, x, kernel=True, stats=True, **kw)
            out[f"routed_{cf}"] = o.numpy()
            out[f"routed_n_{cf}"] = int(n)
    np.savez(dst, **out)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results, one subprocess with two host devices."""
    path = str(tmp_path_factory.mktemp("moe_mesh") / "ref.npz")
    env = _env(JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    subprocess.run([sys.executable, "-c", REF, path], env=env, check=True,
                   timeout=300)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port12(ref, tmp_path_factory):
    """The port's (1, 2) results, two gloo ranks in two subprocesses."""
    d = tmp_path_factory.mktemp("moe_mesh_port")
    src = str(d / "in.npz")
    np.savez(src, **{k: v for k, v in ref.items()
                     if k == "x" or k.startswith("p_")})
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT, src, str(d / f"r{r}.npz"), str(r),
         port], env=_env()) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0
    finally:
        for p in procs:
            p.kill()
    return [dict(np.load(str(d / f"r{r}.npz"))) for r in range(2)]


def _params(ref):
    return {k[2:]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith("p_")}


def _kw(cf):
    return dict(n_experts=CFG.n_experts, top_k=CFG.top_k,
                capacity_factor=cf)


def _shard_slots(ref, cf, shard, n_shards):
    """The reference's flat slot table as model shard ``shard`` of
    ``n_shards`` holds it (expert-parallel)."""
    slot, experts = ref[f"slot_{cf}"], ref[f"experts_{cf}"]
    e_loc = CFG.n_experts // n_shards
    lo = shard * e_loc
    home = (experts >= lo) & (experts < lo + e_loc) & (slot >= 0)
    return np.where(home, slot - lo * ref[f"cap_{cf}"], -1).astype(np.int32)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("cf", CFS)
def test_variants_11_match_reference(ref, cf, kernel):
    """EP and TP on a one-rank (1, 1) mesh: poison counts bitwise equal
    to the reference's and the flat path's, outputs bitwise equal to the
    port's flat path and within 1e-6 of the reference's."""
    p, x = _params(ref), torch.from_numpy(ref["x"])
    kw = _kw(cf)
    flat, n_flat = moe._moe_spec_flat(p, x, kernel=kernel, stats=True, **kw)
    assert int(n_flat) == ref[f"flat_n_{cf}_{kernel}"]
    if cf == 0.5:
        assert int(n_flat) > 0, "low capacity must overflow"
    with process_group("gloo"):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        for var, fn in (("ep", moe._moe_spec_ep), ("tp", moe._moe_spec_tp)):
            out, n = fn(p, x, mesh=mesh, kernel=kernel, stats=True, **kw)
            assert int(n) == ref[f"{var}11_n_{cf}"] == int(n_flat)
            assert torch.equal(out, flat), var
            np.testing.assert_allclose(out.numpy(), ref[f"{var}11_{cf}"],
                                       atol=TOL, rtol=TOL)
        w = {k: p[k] for k in ("w_gate", "w_up", "w_down")}
        _, slot = moe._ep_local(p["router"], w["w_gate"], w["w_up"],
                                w["w_down"], x, 0, kernel=kernel, **kw)
        np.testing.assert_array_equal(slot.numpy(),
                                      _shard_slots(ref, cf, 0, 1))
        _, flat_slot, _ = moe._tp_local(p["router"], w["w_gate"],
                                        w["w_up"], w["w_down"], x,
                                        kernel=kernel, **kw)
        np.testing.assert_array_equal(flat_slot.numpy(), ref[f"slot_{cf}"])


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("var", ("ep", "tp"))
def test_variants_12_match_reference(ref, port12, var, cf, kernel):
    """EP and TP on two gloo ranks, a (1, 2) mesh: every rank's global
    poison count bitwise equal to the reference's (1, 2) run and to the
    flat path, each rank's slot table bitwise equal to the reference's,
    outputs within 1e-6 of the reference's (1, 2) run and of flat."""
    for shard, res in enumerate(port12):
        assert res[f"{var}_n_{cf}_{kernel}"] == \
            ref[f"{var}12_n_{cf}"] == ref[f"flat_n_{cf}_{kernel}"]
        for want in (ref[f"{var}12_{cf}"],
                     ref[f"flat_{cf}_{kernel}"]):
            np.testing.assert_allclose(res[f"{var}_{cf}_{kernel}"], want,
                                       atol=TOL, rtol=TOL)
        slot = res[f"{var}_slot_{cf}_{kernel}"]
        want = (_shard_slots(ref, cf, shard, 2) if var == "ep"
                else ref[f"slot_{cf}"])
        np.testing.assert_array_equal(slot, want)
    if var == "ep":
        # every request commits on at most one shard, on its home shard
        live = [r[f"ep_slot_{cf}_{kernel}"] >= 0 for r in port12]
        assert not (live[0] & live[1]).any()
        assert int((live[0] | live[1]).sum()) == \
            ref[f"slot_{cf}"].size - ref[f"flat_n_{cf}_{kernel}"]


@pytest.mark.parametrize("cf", CFS)
def test_moe_spec_routes_to_ep_under_mesh(ref, port12, cf, monkeypatch):
    """``moe_spec`` under ``use_mesh`` takes the expert-parallel variant
    (the smoke config's 4 experts divide the model axis), with
    ``kernel`` and ``stats`` honoured: the reference's EP results on the
    (1, 1) mesh in this process and on the (1, 2) mesh on two ranks."""
    p, x = _params(ref), torch.from_numpy(ref["x"])
    calls = []
    real = moe._moe_spec_ep
    monkeypatch.setattr(moe, "_moe_spec_ep",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    with process_group("gloo"):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        with use_mesh(mesh):
            out, n = moe.moe_spec(p, x, kernel=True, stats=True, **_kw(cf))
    assert len(calls) == 1 and calls[0]["kernel"] and calls[0]["stats"]
    assert int(n) == ref[f"ep11_n_{cf}"]
    np.testing.assert_allclose(out.numpy(), ref[f"ep11_{cf}"], atol=TOL,
                               rtol=TOL)
    for res in port12:
        assert res[f"routed_n_{cf}"] == ref[f"ep12_n_{cf}"]
        np.testing.assert_allclose(res[f"routed_{cf}"], ref[f"ep12_{cf}"],
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("mesh_shape,n,e,ff,want", [
    ((1, 16), 64, 32, 64, "ep"),      # E % model == 0
    ((1, 16), 64, 8, 64, "tp"),       # few experts, ff % model == 0
    ((1, 16), 64, 8, 24, "flat"),     # neither divides
    ((2, 8), 63, 16, 64, "flat"),     # the data axis does not divide N
    ((2, 8), 64, 16, 64, "ep"),
])
def test_moe_spec_variant_rule(mesh_shape, n, e, ff, want, monkeypatch):
    """The reference's selection rule (``repro.models.moe.moe_spec``) on
    meshes of a fake process group."""
    seen = []
    for name in ("ep", "tp", "flat"):
        monkeypatch.setattr(moe, f"_moe_spec_{name}",
                            lambda *a, _n=name, **k: seen.append(_n))
    p = {"w_gate": torch.zeros(e, 4, ff)}
    x = torch.zeros(n, 4)
    with process_group("fake", mesh_shape[0] * mesh_shape[1]):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        with use_mesh(mesh):
            moe.moe_spec(p, x, n_experts=e, top_k=2, capacity_factor=1.0)
    moe.moe_spec(p, x, n_experts=e, top_k=2, capacity_factor=1.0)
    assert seen == [want, "flat"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("var", ("ep", "tp"))
def test_run_shards_matches_ranks(ref, port12, var, cf, kernel):
    """``run_shards`` (every model shard's local function in turn in one
    process, the card's way to run a split it cannot hold as ranks):
    at 2 shards the two gloo ranks' and the reference's (1, 2) results,
    at 4 the flat path's; poison counts and slot tables bitwise."""
    p, x = _params(ref), torch.from_numpy(ref["x"])
    for n in (2, 4):
        seen = []
        out, pois, slots = moe.run_shards(
            p, x, n, variant=var, kernel=kernel,
            each=lambda s, slot: seen.append(s), **_kw(cf))
        assert seen == list(range(n))
        assert int(pois) == ref[f"flat_n_{cf}_{kernel}"]
        wants = [ref[f"flat_{cf}_{kernel}"]]
        if n == 2:
            wants += [ref[f"{var}12_{cf}"], port12[0][f"{var}_{cf}_{kernel}"]]
        for want in wants:
            np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
        for s, slot in enumerate(slots):
            want = (_shard_slots(ref, cf, s, n) if var == "ep"
                    else ref[f"slot_{cf}"])
            np.testing.assert_array_equal(slot.numpy(), want)
