"""Attention over a KV cache sharded on T, on two gloo ranks, against the
reference on two host devices.

The dry run's and the reference's serving layout keeps the KV cache
sharded on its sequence axis over ``model``.  The port writes new keys
and values shard by shard and attends the cache without gathering it
(``repro_torch.models.layers._sharded_cache_attention``): decode is
sequence-parallel (row max, exponentials' sum and the partial ``p @ v``
reduced across the shards), and a prefill that fills the cache is
heads-parallel after one all-to-all.  Here a float32 smoke config of
Mistral-NeMo's family runs on a ``(1, 2)`` ``("data", "model")`` mesh
with one K/V head (the K/V projection's column shards are not whole
heads: keys and values are made whole over ``model``) and with two (the
keys and values stay sharded on heads, and a prefill that fills the
cache writes it by an all-to-all):

* a 6-token prefill with left pads into a 16-position cache (8 a shard),
  then four decode steps at positions 6 to 9, so that the write moves
  from shard 0 into shard 1;
* a 16-token prefill that fills the cache (the heads-parallel layout).

The reference runs both in one subprocess with two forced host devices
(``jax.jit`` with the cache's T-sharded ``out_shardings``, as its dry
run places it); the port on two gloo ranks in two subprocesses, its
parameters placed by ``param_spec`` (``distribute_params``).  Logits are
held to the reference's within 1e-6 and to the port's own unsharded run;
the written cache (gathered) bitwise to the port's unsharded run, whose
cache the same tokens write, and within 1e-6 to the reference's.
"""
from __future__ import annotations

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
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
T_MAX = 16
PADS = np.array([0, 2], np.int32)

#: K/V head counts of the config both packages build (``CONFIG``)
KV_HEADS = (1, 2)
CONFIG = """
    import dataclasses

    def config(kv):
        return dataclasses.replace(base.smoke(base.get("mistral_nemo_12b")),
                                   n_kv_heads=kv)
"""

REF = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import base
    from repro.launch import mesh as mesh_mod
    from repro.models.model import build_model
""") + textwrap.dedent(CONFIG) + textwrap.dedent("""
    def run(cfg, mesh):
        m = build_model(cfg)
        params = m.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(20)
        tok = rng.integers(1, cfg.vocab, (2, 6)).astype(np.int32)
        steps = rng.integers(1, cfg.vocab, (2, 4)).astype(np.int32)
        full = rng.integers(1, cfg.vocab, (2, 16)).astype(np.int32)
        pads = np.array([0, 2], np.int32)
        rep = NamedSharding(mesh, P())
        psh = mesh_mod.shard_pytree_specs(jax.eval_shape(lambda: params),
                                          cfg, mesh, False)
        cache0 = jax.eval_shape(lambda: m.init_cache(2, 16))
        csh = jax.tree.map(lambda l: NamedSharding(
            mesh, P(None, None, None, "model", None)), cache0)
        out = {"params": jax.tree.map(np.asarray, params), "tok": tok,
               "steps": steps, "full": full, "pads": pads}
        pre = jax.jit(lambda p, t, pl: m.prefill(p, t, 16, pad_lens=pl),
                      in_shardings=(psh, rep, rep),
                      out_shardings=(rep, csh))
        dec = jax.jit(lambda p, c, t, pl, n: m.decode_step(
                          p, c, t, n, pad_lens=pl), static_argnums=(4,),
                      in_shardings=(psh, csh, rep, rep),
                      out_shardings=(rep, csh))
        logits, cache = pre(params, tok, pads)
        out["prefill"] = np.asarray(logits)
        for i in range(steps.shape[1]):
            logits, cache = dec(params, cache, steps[:, i:i + 1], pads,
                                6 + i)
            out[f"decode{i}"] = np.asarray(logits)
        out["cache"] = [np.asarray(c) for c in jax.tree.leaves(cache)]
        full_pre = jax.jit(lambda p, t: m.prefill(p, t, 16),
                           in_shardings=(psh, rep), out_shardings=(rep, csh))
        logits, cache = full_pre(params, full)
        out["full_prefill"] = np.asarray(logits)
        out["full_cache"] = [np.asarray(c) for c in jax.tree.leaves(cache)]
        return out

    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("data", "model"))
    with mesh:
        out = {kv: run(config(kv), mesh) for kv in (1, 2)}
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
""")

#: one rank of the port's (1, 2) run: argv = pickle in, pickle out, rank,
#: rendezvous port
PORT = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import base
    from repro_torch.launch.mesh import distribute_params, process_group
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import _sharded_cache_attention
    from repro_torch.models.model import build_model
    from repro_torch.models.sharding import use_mesh
""") + textwrap.dedent(CONFIG) + textwrap.dedent("""
    src, dst, rank, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
        sys.argv[4]
    with open(src, "rb") as fh:
        refs = pickle.load(fh)
    # all-to-alls by phase: the heads-parallel layout's, and nowhere else
    a2a = {"n": 0}
    real_a2a = dist.all_to_all_single

    def counted(*args, **kw):
        a2a["n"] += 1
        return real_a2a(*args, **kw)

    dist.all_to_all_single = counted

    def run(cfg, ref, mesh):
        m = build_model(cfg)
        tok, steps, full, pads = (torch.from_numpy(ref[k])
                                  for k in ("tok", "steps", "full", "pads"))
        rep = [Replicate(), Replicate()]

        def t_sharded(t):
            d = DTensor.from_local(t, mesh, rep, run_check=False)
            return d.redistribute(mesh, [Replicate(), Shard(2)])

        def fresh_cache():
            caches, states = m.init_cache(2, 16)
            return [[tuple(t_sharded(t) for t in kv) for kv in g]
                    for g in caches], states

        def gathered(cache):
            return [torch.stack([g[a][i].full_tensor() for g in cache[0]])
                    for a in range(len(cache[0][0])) for i in (0, 1)]

        out = {}
        params = distribute_params(params_from_numpy(ref["params"]), cfg,
                                   mesh)
        a2a["n"] = 0
        cache = fresh_cache()
        logits, cache = m._forward(params, tok, cache, 0, None, pads, False)
        out["prefill"] = logits.full_tensor()
        for i in range(steps.shape[1]):
            logits, cache = m.decode_step(params, cache, steps[:, i:i + 1],
                                          6 + i, pad_lens=pads)
            out[f"decode{i}"] = logits.full_tensor()
        out["cache"] = gathered(cache)
        out["a2a_decode"] = a2a["n"]
        cache = fresh_cache()
        logits, cache = m._forward(params, full, cache, 0, None, None, False)
        out["full_prefill"] = logits.full_tensor()
        out["full_cache"] = gathered(cache)
        out["a2a_full"] = a2a["n"] - out["a2a_decode"]
        # the layer alone: three tokens written at 6, 7 and 8 (across the
        # shard boundary) and attended, on replicated q, k, v
        g = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn(shp, generator=g) for shp in (
            (2, 4, 3, 16), (2, 1, 3, 16), (2, 1, 3, 16)))
        ck, cv = (t_sharded(torch.randn(2, 1, 16, 16, generator=g))
                  for _ in range(2))
        o = _sharded_cache_attention(
            *(DTensor.from_local(t, mesh, rep, run_check=False)
              for t in (q, k, v)), ck, cv, 6, pads)
        out["layer"] = (o.full_tensor(), ck.full_tensor(), cv.full_tensor())
        return out

    with process_group("gloo", 2, rank, f"tcp://localhost:{port}"):
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        # plain tensors made inside the step (positions, masks) take part
        # as replicated values, as the dry run runs it
        with use_mesh(mesh), implicit_replication():
            out = {kv: run(config(kv), refs[kv], mesh) for kv in (1, 2)}
    with open(dst, "wb") as fh:
        pickle.dump(out, fh)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's two-device run, then the port's two gloo ranks on
    the reference's parameters and tokens."""
    d = tmp_path_factory.mktemp("attn_mesh")
    src = str(d / "ref.pkl")
    subprocess.run([sys.executable, "-c", REF, src], check=True,
                   timeout=300,
                   env=_env(JAX_PLATFORMS="cpu",
                            XLA_FLAGS="--xla_force_host_platform_device_"
                                      "count=2"))
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", PORT, src, str(d / f"r{r}.pkl"), str(r),
         port], env=_env()) for r in range(2)]
    try:
        for p in procs:
            assert p.wait(timeout=300) == 0
    finally:
        for p in procs:
            p.kill()
    with open(src, "rb") as fh:
        ref = pickle.load(fh)
    ranks = []
    for r in range(2):
        with open(str(d / f"r{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    return ref, ranks


@pytest.fixture(scope="module")
def flat(runs):
    """The port's unsharded run of the same steps (plain tensors), by
    K/V head count."""
    ns = {}
    exec("from repro_torch.configs import base\n"
         + textwrap.dedent(CONFIG), ns)
    res = {}
    for kv in KV_HEADS:
        ref = runs[0][kv]
        m = build_model(ns["config"](kv))
        params = params_from_numpy(ref["params"])
        tok, steps, full, pads = (torch.from_numpy(ref[k])
                                  for k in ("tok", "steps", "full", "pads"))
        out = {}
        logits, cache = m.prefill(params, tok, T_MAX, pad_lens=pads)
        out["prefill"] = logits
        for i in range(steps.shape[1]):
            logits, cache = m.decode_step(params, cache, steps[:, i:i + 1],
                                          6 + i, pad_lens=pads)
            out[f"decode{i}"] = logits
        out["cache"] = [torch.stack([g[0][i] for g in cache[0]])
                        for i in (0, 1)]
        logits, cache = m.prefill(params, full, T_MAX)
        out["full_prefill"] = logits
        out["full_cache"] = [torch.stack([g[0][i] for g in cache[0]])
                             for i in (0, 1)]
        res[kv] = out
    return res


@pytest.mark.parametrize("kv", KV_HEADS)
def test_layer_write_and_attention(runs, kv):
    """``_sharded_cache_attention`` alone, three tokens at 6 to 8 (shard 0
    then shard 1) on each rank: the written cache bitwise the plain slice
    write's, the output within 1e-6 of the unsharded
    ``_decode_attention``."""
    from repro_torch.models.layers import _decode_attention
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shp, generator=g) for shp in (
        (2, 4, 3, 16), (2, 1, 3, 16), (2, 1, 3, 16)))
    ck, cv = (torch.randn(2, 1, 16, 16, generator=g) for _ in range(2))
    ck[:, :, 6:9] = k
    cv[:, :, 6:9] = v
    want = _decode_attention(q, ck.repeat_interleave(4, dim=1),
                             cv.repeat_interleave(4, dim=1), 9,
                             pad_len=torch.from_numpy(PADS))
    for res in runs[1]:
        out, got_k, got_v = res[kv]["layer"]
        assert torch.equal(got_k, ck) and torch.equal(got_v, cv)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL)


STEPS = ["prefill", "decode0", "decode1", "decode2", "decode3",
         "full_prefill"]


@pytest.mark.parametrize("kv", KV_HEADS)
@pytest.mark.parametrize("step", STEPS)
def test_logits_match_reference(runs, flat, step, kv):
    """Each rank's logits within 1e-6 of the reference's two-device run
    and of the port's unsharded run."""
    ref, ranks = runs
    for res in ranks:
        got = res[kv][step].numpy()
        np.testing.assert_allclose(got, ref[kv][step], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got, flat[kv][step].numpy(), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("kv", KV_HEADS)
@pytest.mark.parametrize("which", ["cache", "full_cache"])
def test_cache_written_in_place(runs, flat, which, kv):
    """The T-sharded cache, gathered: the first layer's (whose keys and
    values come from the same embeddings on both runs) bitwise the
    unsharded run's, every layer within 1e-6 of it and of the
    reference's; the decode steps at 6 and 7 landed on shard 0, at 8 and
    9 on shard 1, and nothing past them was written.  Decode takes the
    sequence-parallel layout (no all-to-all); the prefill that fills the
    cache the heads-parallel one (two all-to-alls a layer to read the
    cache, and two more to write it where the keys and values are
    sharded on heads)."""
    ref, ranks = runs
    for res in ranks:
        for got, want, mine in zip(res[kv][which], ref[kv][which],
                                   flat[kv][which]):
            assert torch.equal(got[0], mine[0])
            for other in (want, mine.numpy()):
                np.testing.assert_allclose(got.numpy(), other, atol=TOL,
                                           rtol=TOL)
    n_layers = len(ranks[0][kv][which][0])
    writes = 2 if kv % 2 == 0 else 0
    for res in ranks:
        assert res[kv]["a2a_decode"] == 0
        assert res[kv]["a2a_full"] == (2 + writes) * n_layers
    if which == "cache":
        k = ranks[0][kv]["cache"][0]
        assert (k[:, :, :, 6:10].abs().amax(dim=(0, 1, 2, 4)) > 0).all()
        assert k[:, :, :, 10:].abs().sum() == 0


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("t,cache_len", [(1, 16), (2, 15), (3, 7)])
def test_decode_shards_match_flat(n_shards, t, cache_len):
    """``gqa_decode_shards`` (the T-split run shard by shard in one
    process through the mesh's own ``seq_parallel``, as chip_smoke.py's
    ``[mesh-attn]`` runs it on the card) on the Kimi-K2 smoke config: the
    cache bitwise the flat layer's, the output within 1e-6; a write at 15
    crosses the boundary of 2 and 4 shards of a 32-position cache."""
    from repro_torch.models import layers
    from repro_torch.models.model import init_sublayer
    cfg = base.smoke(base.get("kimi_k2_1t_a32b"))
    g = torch.Generator().manual_seed(t)
    p = init_sublayer(cfg, "attn", g, "cpu")
    ck = torch.randn(3, cfg.n_kv_heads, 32, cfg.hd, generator=g)
    cv = torch.randn(ck.shape, generator=g)
    x = torch.randn(3, t, cfg.d_model, generator=g)
    pad = torch.tensor([0, 2, 5], dtype=torch.int32)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, theta=cfg.rope_theta, cache_len=cache_len,
              pad_len=pad)
    flat_kv = (ck.clone(), cv.clone())
    want, _ = layers.gqa_attention(p, x, pos_offset=cache_len,
                                   kv_cache=flat_kv, **kw)
    got_kv = (ck.clone(), cv.clone())
    got, _ = layers.gqa_decode_shards(p, x, kv_cache=got_kv,
                                      n_shards=n_shards, **kw)
    assert torch.equal(got_kv[0], flat_kv[0])
    assert torch.equal(got_kv[1], flat_kv[1])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)
