"""The port's mesh layer against the reference's sharding rules, on the
CPU.

``repro_torch.launch.mesh.param_spec`` is held to
``repro.launch.mesh.param_spec`` for every parameter of every config at
full width (shapes from the port's meta-device init, nothing drawn), on
both production meshes, with and without FSDP, at the port's per-layer
shapes and at the reference's stacked ones.  The reference's rules read
only ``mesh.shape[...]`` and ``mesh.axis_names``, so they get a
stand-in object and no JAX devices; the port's get a ``DeviceMesh`` of a
fake process group of 256 or 512 ranks.  Also ``needs_fsdp``,
``batch_spec``, ``constrain``'s drop rules, ``distribute_params`` and
the elastic restore on a one-rank gloo group, and ``remesh``.
"""
from __future__ import annotations

import types

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import base as rbase
from repro.launch import mesh as rmesh
from repro_torch.configs import base
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.mesh import process_group
from repro_torch.models.model import build_model
from repro_torch.models.sharding import (constrain, placements,
                                         resolve_spec, use_mesh)
from repro_torch.optim.tree import map_parts

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(multi_pod: bool):
    """What the reference's rules read of a ``jax.sharding.Mesh``."""
    shape, names = MESHES[multi_pod]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _leaves(cfg):
    """``(path, port shape, stacked)`` of every parameter of the port's
    meta-device init; ``stacked`` says whether the reference stacks it
    along a leading group axis."""
    params = build_model(cfg).init(torch.Generator(), "meta")
    out = []
    map_parts(lambda path, group, t: out.append(
        ("/".join(path), tuple(t.shape), group)), params)
    return [(p, s, g is not None) for p, s, g in out
            if g is None or g == 0]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", base.ASSIGNED)
def test_param_spec_matches_reference(arch, multi_pod):
    cfg, rcfg = base.get(arch), rbase.get(arch)
    ref_mesh = _stand_in(multi_pod)
    n = 512 if multi_pod else 256
    with process_group("fake", n):
        mesh = pmesh.make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu")
        assert mesh.shape == MESHES[multi_pod][0]
        assert pmesh.data_axes(mesh) == tuple(rmesh.data_axes(ref_mesh))
        checked = sharded = 0
        for path, shape, stacked in _leaves(cfg):
            shapes = [shape] + ([(cfg.n_layers,) + shape] if stacked else [])
            for shp in shapes:
                for fsdp in (False, True):
                    got = pmesh.param_spec(path, shp, cfg, mesh, fsdp)
                    want = tuple(rmesh.param_spec(path, shp, rcfg, ref_mesh,
                                                  fsdp))
                    assert got == want, (path, shp, fsdp)
                    checked += 1
                    sharded += any(a is not None for a in got)
        assert sharded > 0 and checked > 0


def test_shard_pytree_specs_and_rules():
    """Placements per leaf equal ``placements(param_spec(...))``;
    Kimi-K2's experts go EP over ``model`` (FSDP on ``data``), Grok-1's
    shard their FFN width, vectors replicate, the embedding shards its
    vocabulary."""
    with process_group("fake", 256):
        mesh = pmesh.make_production_mesh(device_type="cpu")
        cfg = base.get("kimi_k2_1t_a32b")
        params = build_model(cfg).init(torch.Generator(), "meta")
        specs = pmesh.shard_pytree_specs(params, cfg, mesh, fsdp=True)
        moe = specs["groups"][0]["s1_moe"]
        assert moe["w_gate"] == [Shard(1), Shard(0)]       # data, model
        assert specs["embed"] == [Shard(1), Shard(0)]       # d, vocab
        assert specs["groups"][0]["s0_attn"]["ln"] == [Replicate()] * 2
        assert specs["groups"][0]["s0_attn"]["wo"] == [Shard(1), Shard(0)]
        grok = base.get("grok_1_314b")
        s = pmesh.param_spec("groups/s1_moe/w_gate", (8, 6144, 32768),
                             grok, mesh, fsdp=False)
        assert s == (None, None, "model")
        s = pmesh.param_spec("groups/s1_moe/w_down", (8, 32768, 6144),
                             grok, mesh, fsdp=False)
        assert s == (None, "model", None)


@pytest.mark.parametrize("arch", base.ASSIGNED)
def test_needs_fsdp_matches_reference(arch):
    assert pmesh.needs_fsdp(base.get(arch)) == rmesh.needs_fsdp(
        rbase.get(arch))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("seq_axis", [False, True])
def test_batch_spec_matches_reference(multi_pod, seq_axis):
    n = 512 if multi_pod else 256
    with process_group("fake", n):
        mesh = pmesh.make_production_mesh(multi_pod=multi_pod,
                                          device_type="cpu")
        got = pmesh.batch_spec(mesh, seq_axis=seq_axis)
    want = tuple(rmesh.batch_spec(_stand_in(multi_pod), seq_axis=seq_axis))
    assert _norm(got) == _norm(want)


def _norm(spec):
    """A spec with one-name tuples as the name (``PartitionSpec``
    flattens ``("data",)`` to ``"data"``)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def test_constrain_drop_rules():
    """``"dp"`` expands to the data axes, unknown and non-dividing axes
    drop to None; a DTensor is redistributed to the result, a plain
    tensor or no mesh passes through untouched."""
    with process_group("fake", 512):
        mesh = pmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        assert resolve_spec((64, 7, 32), ("dp", "model", "model"), mesh) \
            == (("pod", "data"), None, "model")
        assert resolve_spec((64, 32), ("expert", ("data", "model")),
                            mesh) == (None, None)          # 32 % 256
        assert resolve_spec((64, 512), (None, ("data", "model")), mesh) \
            == (None, ("data", "model"))
        assert placements((("pod", "data"), None, "model"), mesh) == [
            Shard(0), Shard(0), Shard(2)]
        x = DTensor.from_local(torch.zeros(64, 7, 32), mesh,
                               [Replicate()] * 3, run_check=False)
        plain = torch.zeros(64, 7, 32)
        assert constrain(x, "dp", None, "model") is x        # no mesh
        with use_mesh(mesh):
            y = constrain(x, "dp", "model", "model")
            assert constrain(plain, "dp", None, "model") is plain
        assert y.placements == (Shard(0), Shard(0), Shard(2))
        assert y.to_local().shape == (2, 7, 2)
    with process_group("fake", 256):
        mesh = pmesh.make_production_mesh(device_type="cpu")
        assert resolve_spec((8, 16), ("dp", "model"), mesh) == (None, "model")


def _gloo_mesh():
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def test_distribute_params_gloo():
    """The weights carried across onto a one-rank gloo mesh: every leaf a
    DTensor with the rules' placements and the full tensor's values."""
    cfg = base.smoke(base.get("kimi_k2_1t_a32b"))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with process_group("gloo"):
        mesh = _gloo_mesh()
        placed = pmesh.distribute_params(params, cfg, mesh, fsdp=True)
        seen = []

        def check(path, group, t):
            got = placed["groups"][group] if group is not None else placed
            for k in path[1:] if group is not None else path:
                got = got[k]
            assert isinstance(got, DTensor)
            spec = pmesh.param_spec("/".join(path), tuple(t.shape), cfg,
                                    mesh, True)
            assert list(got.placements) == placements(spec, mesh)
            assert torch.equal(got.full_tensor(), t)
            seen.append(path)

        map_parts(check, params)
        assert len(seen) > 10
        moe = placed["groups"][0]["s1_moe"]["w_gate"]
        assert moe.placements == (Shard(1), Shard(0))


def test_restore_onto_mesh(tmp_path):
    """The elastic restart: a checkpoint of plain tensors restored with
    ``shard_fn`` = ``distribute_params`` onto a new mesh, bitwise; a
    DTensor state snapshots to its full value."""
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = base.smoke(base.get("phi4_mini_3_8b"))
    params = build_model(cfg).init(torch.Generator().manual_seed(3), "cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params})
    with process_group("gloo"):
        mesh = _gloo_mesh()
        back = mgr.restore(shard_fn=lambda t: pmesh.distribute_params(
            t, cfg, mesh))
        emb = back["params"]["embed"]
        assert isinstance(emb, DTensor)
        assert torch.equal(emb.full_tensor(), params["embed"])
        mgr.save(2, back)
    again = mgr.restore(2)
    assert torch.equal(again["params"]["groups"][1]["s0_attn"]["wq"],
                       params["groups"][1]["s0_attn"]["wq"])


@pytest.mark.parametrize("n,shape", [(256, (16, 16)), (240, (15, 16)),
                                     (512, (2, 16, 16))])
def test_remesh(n, shape):
    """``remesh`` builds ``plan_remesh``'s shape as a ``DeviceMesh``."""
    from repro_torch.train.fault import plan_remesh, remesh
    assert plan_remesh(n) == shape
    with process_group("fake", n):
        mesh = remesh(n, device_type="cpu")
        assert mesh.shape == shape
        assert mesh.mesh_dim_names[-2:] == ("data", "model")
