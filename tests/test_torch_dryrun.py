"""The port's dry run on the CPU: the cell matrix's skip logic and input
specs against the reference's, the roofline arithmetic with the H100
constants, the per-device cost counter (a plain matmul, a sharded one
on a fake 16 x 16 mesh, a loop, each collective kind), and one smoke
cell end to end on a fake 2 x 2 mesh per step kind (the counterpart of
``tests/test_system.py``'s dry-run cell).
"""
from __future__ import annotations

import json
import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import base as rbase
from repro_torch.configs import base
from repro_torch.launch import dryrun, dryrun_all, roofline
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import process_group


@pytest.fixture(scope="module")
def rdryrun():
    """The reference's dry-run module (its import sets ``XLA_FLAGS`` for
    later processes; this process's jax is already up)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


def test_skip_logic_matches_reference(rdryrun):
    assert sorted(dryrun.SHAPES) == sorted(rdryrun.SHAPES)
    runnable = 0
    for arch in base.ASSIGNED:
        for shape in dryrun.SHAPES:
            assert dryrun.SHAPES[shape] == rdryrun.SHAPES[shape]
            got = dryrun.shape_skip_reason(base.get(arch), shape)
            assert got == rdryrun.shape_skip_reason(rbase.get(arch), shape)
            runnable += got is None
    assert runnable == 32          # + 8 documented skips = 40 cells


@pytest.mark.parametrize("arch", base.ASSIGNED)
def test_input_specs_match_reference(arch, rdryrun):
    import numpy as np
    cfg, rcfg = base.get(arch), rbase.get(arch)
    for shape in dryrun.SHAPES:
        if dryrun.shape_skip_reason(cfg, shape):
            continue
        got = dryrun.input_specs(cfg, shape)
        want = rdryrun.input_specs(rcfg, shape)
        assert sorted(got) == sorted(want)
        assert "tokens" in got and got["tokens"][1] == torch.int32
        for k, (shp, dt) in got.items():
            assert shp == tuple(want[k].shape), (k, shape)
            assert str(dt).removeprefix("torch.") == \
                np.dtype(want[k].dtype).name, (k, shape)


def test_roofline_analysis_math():
    """The reference's test with the H100 constants."""
    rec = {
        "arch": "x", "shape": "train_4k", "n_devices": 256,
        "flops": 989e12,            # exactly 1 s of compute per chip
        "bytes_accessed": 3.35e12,  # exactly 1 s of HBM per chip
        "collective_bytes": {"total": 900e9},  # 2 s of NVLink
        "params_active": 1e9,
    }
    r = roofline.analyze(rec)
    assert abs(r.compute_s - 1.0) < 1e-6
    assert abs(r.memory_s - 1.0) < 1e-6
    assert abs(r.collective_s - 2.0) < 1e-6
    assert r.dominant == "collective"
    assert r.step_time_s == r.collective_s
    assert abs(r.model_flops - 6e9 * 256 * 4096) / r.model_flops < 1e-9
    assert roofline.H100_SXM_BF16_FLOPS == 989e12
    assert roofline.H100_SXM_HBM3_BW == 3.35e12
    assert roofline.H100_SXM_NVLINK_BW == 450e9
    skipped = roofline.analyze({"arch": "x", "shape": "long_500k",
                                "skipped": "why"})
    assert skipped.skipped == "why" and "SKIP" in skipped.row()


def test_cost_plain_matmul_and_loop():
    """2 x M x N x K per product, operands and result bytes once; a
    Python loop counts each step, as a ``while`` body times its trips."""
    a = torch.zeros(64, 32)
    b = torch.zeros(32, 16)
    c = CostCounter()
    with c:
        a @ b
    assert c.dot_flops == 2 * 64 * 16 * 32
    assert c.dot_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    loop = CostCounter()
    with loop:
        x = torch.zeros(8, 32)
        for _ in range(7):
            x = torch.bmm(x[None], torch.zeros(1, 32, 32))[0]
    assert loop.dot_flops == 7 * 2 * 8 * 32 * 32
    assert loop.totals()["collective_total"] == 0


def test_cost_sharded_matmul_is_per_device():
    """The product of ``[4096, 7168] @ [7168, 2048]`` sharded
    ``(Shard(0), Replicate) x (Replicate, Shard(1))`` on a fake 16 x 16
    mesh: each device multiplies 256 x 7168 by 7168 x 128, 469,762,048
    FLOPs (the global product, 120,259,084,288, is nobody's work)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with process_group("fake", 256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(256, 7168,
                                               dtype=torch.bfloat16),
                                   mesh, [Shard(0), Replicate()],
                                   run_check=False)
            b = DTensor.from_local(torch.empty(7168, 128,
                                               dtype=torch.bfloat16),
                                   mesh, [Replicate(), Shard(1)],
                                   run_check=False)
            c = CostCounter()
            with c:
                out = a @ b
    assert tuple(out.shape) == (4096, 2048)
    assert c.dot_flops == 2 * 256 * 128 * 7168 == 469_762_048
    assert c.dot_bytes == 2 * (256 * 7168 + 7168 * 128 + 256 * 128)
    assert c.totals()["collective_total"] == 0


def test_cost_collectives_by_kind():
    """Each kind counts its result's bytes (the reference's HLO count):
    DTensor's redistributions and direct ``torch.distributed`` calls."""
    with process_group("fake", 16):
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        group = mesh.get_group("model")
        x = DTensor.from_local(torch.zeros(8, 32), mesh,
                               [Shard(0), Replicate()], run_check=False)
        c = CostCounter()
        with c:
            x.redistribute(mesh, [Replicate(), Replicate()])   # all-gather
            t = torch.zeros(8, 32)
            dist.all_reduce(t, group=group)
            out = torch.zeros(2, 32)
            dist.reduce_scatter_tensor(out, t, group=group)
            a2a = torch.zeros(8, 32)
            dist.all_to_all_single(a2a, t, group=group)
        tot = c.totals()
    assert tot["all-gather"] == 4 * 32 * 32      # (32, 32) float32
    assert tot["all-reduce"] == 4 * 8 * 32
    assert tot["reduce-scatter"] == 4 * 2 * 32
    assert tot["all-to-all"] == 4 * 8 * 32
    assert tot["collective_total"] == sum(tot[k] for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"))


@pytest.mark.parametrize("placements", [
    (Shard(0), Shard(1)),     # batch over data, heads over model
    (Replicate(), Shard(1)),  # heads over model
    (Shard(0), Replicate()),  # batch over data
])
def test_cost_attention_loop_state_is_per_device(placements):
    """The plain chunked-attention loop on DTensors (the dry run's path)
    holds its running state (m, l and the float32 accumulator) as shards
    of q: the live peak the counter reports, its products and its
    collectives (none) are those of the same loop on one rank's local
    shards, not of q's global shape."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ref
    b, h, tq, tk, d = 4, 8, 40, 72, 32
    with process_group("fake", 4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(0)
        xs = [distribute_tensor(torch.randn(b, h, t, d, generator=g), mesh,
                                list(placements)) for t in (tq, tk, tk)]
        local = [x.to_local().clone() for x in xs]
        counted = CostCounter()
        with implicit_replication(), counted:
            out = ref.chunked_attention(*xs, causal=True, chunk=16,
                                        q_offset=5)
        plain = CostCounter()
        with plain:
            want = ref.chunked_attention(*local, causal=True, chunk=16,
                                         q_offset=5)
    assert tuple(out.placements) == placements
    assert torch.equal(out.to_local(), want)
    assert counted.peak_bytes == plain.peak_bytes
    assert (counted.dot_flops, counted.dot_bytes) == (plain.dot_flops,
                                                      plain.dot_bytes)
    assert counted.totals()["collective_total"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("placements", [
    (Shard(0), Shard(1)),
    (Replicate(), Shard(1)),
    (Shard(0), Replicate()),
])
def test_cost_attention_loop_backward_is_per_device(placements, dtype):
    """The loop forward and its autograd backward on DTensors (the dry
    run's training cells): the counted live peak and products are one
    rank's, with no collective, and the gradients are the local loop's,
    bitwise, placed as their inputs."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import ref
    b, h, tq, tk, d = 4, 8, 40, 72, 32
    with process_group("fake", 4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g = torch.Generator().manual_seed(1)
        full = [torch.randn(b, h, t, d, generator=g).to(dtype)
                for t in (tq, tk, tk, tq)]
        xs = [distribute_tensor(t, mesh, list(placements)).requires_grad_()
              for t in full[:3]]
        dout = distribute_tensor(full[3], mesh, list(placements))
        local = [x.to_local().detach().clone().requires_grad_()
                 for x in xs]
        counted = CostCounter()
        with implicit_replication(), counted:
            out = ref.chunked_attention(*xs, causal=True, chunk=16,
                                        q_offset=5)
            grads = torch.autograd.grad(out, xs, dout)
        plain = CostCounter()
        with plain:
            want = torch.autograd.grad(
                ref.chunked_attention(*local, causal=True, chunk=16,
                                      q_offset=5), local, dout.to_local())
    assert counted.peak_bytes == plain.peak_bytes
    assert counted.dot_flops == plain.dot_flops
    assert counted.totals()["collective_total"] == 0
    for got, w in zip(grads, want):
        assert tuple(got.placements) == placements
        assert torch.equal(got.to_local(), w)


@pytest.mark.parametrize("arch,shape", [
    ("phi4_mini_3_8b", "train_4k"),       # tests/test_system.py's cell
    ("kimi_k2_1t_a32b", "decode_32k"),    # expert-parallel MoE
    ("grok_1_314b", "prefill_32k"),       # tensor-parallel MoE
    ("jamba_1_5_large_398b", "long_500k"),  # batch 1: replicated ops
])
def test_smoke_cell_end_to_end(arch, shape, capsys):
    rec = dryrun.run_cell(arch, shape, False, smoke_cell=True)
    line = capsys.readouterr().out.splitlines()[0]
    assert json.loads(line)["flops"] == rec["flops"]
    assert rec["n_devices"] == 4 and rec["flops"] > 0
    assert rec["bytes_accessed"] > 0
    assert rec["collective_bytes"]["total"] > 0   # TP/FSDP communicate
    assert set(rec["collective_bytes"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total"}
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > rec["param_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    if shape == "train_4k":                # the state is updated in place
        assert mem["alias_size_in_bytes"] > 0
    if shape == "long_500k":
        assert rec["replicated_ops"]       # listed, not hidden
    r = roofline.analyze(rec)
    assert r.compute_s > 0 and r.dominant in ("compute", "memory",
                                               "collective")


@pytest.mark.parametrize("arch,shape", [
    ("rwkv6_7b", "train_4k"),               # RWKV-6 scan, forward + backward
    ("rwkv6_7b", "prefill_32k"),
    ("jamba_1_5_large_398b", "train_4k"),   # Mamba scans beside attention
    ("jamba_1_5_large_398b", "prefill_32k"),
])
def test_scan_shortcut_counts_the_full_loop(arch, shape, capsys):
    """The dry run's SSM scans run two steps and count the second once
    for every later step: the same FLOPs, matmul bytes and collectives
    (by kind, bytes and calls) as running every step."""
    short = dryrun.run_cell(arch, shape, False, smoke_cell=True)
    full = dryrun.run_cell(arch, shape, False, smoke_cell=True,
                           full_scans=True)
    capsys.readouterr()
    assert dryrun.SMOKE_SHAPES[shape]["seq"] > 2   # the shortcut applies
    for key in ("flops", "bytes_accessed", "collective_bytes",
                "collective_calls"):
        assert short[key] == full[key], key
    assert short["flops"] > 0


def test_dryrun_all_writes_skips(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun_all, "RESULTS", str(tmp_path))
    assert dryrun_all.run_matrix(("single",),
                                 only=["phi4_mini_3_8b:long_500k"]) == 0
    rec = json.loads((tmp_path /
                      "phi4_mini_3_8b__long_500k__single.json").read_text())
    assert "skipped" in rec
    assert roofline.analyze(rec).skipped
