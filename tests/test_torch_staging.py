"""The staged route of the port's speculative kernels, on the CPU.

* the ring (:mod:`repro_torch.kernels.staging`): slots handed out in turn,
  growth by doubling, and a slot with a pending launch handed out again
  only after its event completed (a stand-in event on the CPU);
* ``spec_gather_staged`` / ``spec_scatter_add_staged`` on CPU tables
  (the codegen drivers' int32 tables of one-element rows) against the
  port's plain versions and ``repro.kernels.ref`` on the same seeded
  numpy inputs, bitwise: n not a multiple of 4, n = 0, every request
  poisoned, indices past the last row (clip) and duplicate destinations;
* the four fault sites, armed alone, doing to the staged route what they
  do to the tensor route and to the reference wrappers;
* argument checks, and that nothing is launched on the CPU.

The CUDA kernels of the staged route are tested on the card by
``tests/test_torch_cuda.py``.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.spec_gather import spec_gather as jgather
from repro.kernels.spec_scatter import spec_scatter_add as jscatter
from repro.resilience import faults as jfaults
from repro_torch.kernels import ref, staging
from repro_torch.kernels.spec_gather import spec_gather, spec_gather_staged
from repro_torch.kernels.spec_scatter import (spec_scatter_add,
                                              spec_scatter_add_staged)
from repro_torch.kernels.staging import Ring
from repro_torch.resilience import faults

#: (rows, n, kind): n off a multiple of 4, n = 0, n past a new slot's
#: capacity (growth); kinds: "mixed" (poison, in range, past the last
#: row), "poison" (every request -1), "dups" (few destinations, many
#: requests each)
CASES = [(61, 37, "mixed"), (61, 4, "mixed"), (61, 1, "mixed"),
         (61, 0, "mixed"), (61, 6, "mixed"), (8, 5, "poison"),
         (8, 4096, "poison"), (3, 23, "dups"), (7, 4099, "dups"),
         (65536, 512, "mixed"), (40, 1030, "mixed")]


def staged_inputs(rows, n, kind, seed=11):
    """An int32 ``(rows, 1)`` table, ``n`` indices and ``(n, 1)`` values
    for one case (numpy)."""
    rng = np.random.default_rng(seed + rows + n)
    if kind == "poison":
        idx = np.full(n, -1, np.int32)
    elif kind == "dups":
        idx = rng.integers(-1, min(rows, 3), n).astype(np.int32)
    else:
        idx = rng.integers(-3, rows + 4, n).astype(np.int32)
    tab = rng.integers(-2 ** 31, 2 ** 31, (rows, 1),
                       dtype=np.int64).astype(np.int32)
    val = rng.integers(-2 ** 31, 2 ** 31, (n, 1),
                       dtype=np.int64).astype(np.int32)
    return tab, idx, val


def stage(ring, idx, val):
    """A slot of ``ring`` holding ``idx`` and ``val``."""
    n = len(idx)
    slot = ring.acquire(n)
    slot.idx[:n] = idx
    slot.val[:n] = val[:, 0]
    return slot


class FakeEvent:
    """A CUDA event's stand-in: ``synchronize`` counts its calls and
    completes the event."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def test_ring_hands_out_slots_in_turn_and_grows_by_doubling():
    ring = Ring("cpu", slots=3, capacity=4)
    a, b, c = ring.slots
    assert [ring.acquire(1) for _ in range(4)] == [a, b, c, a]
    assert [s.capacity for s in ring.slots] == [4, 4, 4]
    assert ring.acquire(9) is b  # 4 -> 8 -> 16
    assert b.capacity == 16
    assert b.idx.size == b.val.size == b.out.size == 16
    assert b.idx.dtype == b.val.dtype == b.out.dtype == np.int32
    assert (a.capacity, c.capacity) == (4, 4)
    assert ring.acquire(16) is c and c.capacity == 16
    assert ring.acquire(3) is a and a.capacity == 4  # never shrinks


def test_slot_is_handed_out_again_only_after_its_event():
    ring = Ring("cpu", slots=2, event=FakeEvent)
    s0, s1 = ring.slots
    assert ring.acquire(1) is s0
    s0.launched()  # a scatter that reads s0 after the call returns
    assert s0.pending
    assert ring.acquire(1) is s1 and s0.event.waits == 0
    # s0 comes round again: its event is waited for before it is handed out
    assert ring.acquire(1) is s0
    assert s0.event.waits == 1 and not s0.pending
    # a slot with no pending launch is handed out without a wait
    assert ring.acquire(1) is s1 and s1.event.waits == 0
    assert ring.acquire(1) is s0 and s0.event.waits == 1
    # growth waits first, then replaces the buffers
    s0.launched()
    assert ring.acquire(1) is s1
    grown = ring.acquire(5000)
    assert grown is s0 and s0.event.waits == 2 and s0.capacity == 8192


def test_drain_and_release_wait_for_pending_slots():
    ring = Ring("cpu", slots=3, event=FakeEvent)
    s0, s1, s2 = ring.slots
    ring.acquire(1).launched()
    ring.acquire(1).launched()
    ring.drain()
    assert (s0.event.waits, s1.event.waits, s2.event.waits) == (1, 1, 0)
    assert not (s0.pending or s1.pending)
    ring.acquire(1).launched()
    del ring
    gc.collect()
    assert s2.event.waits == 1 and not s2.pending


def test_cpu_ring_has_no_events_and_no_device_addresses():
    ring = Ring("cpu")
    for s in ring.slots:
        assert s.event is None and s.idx_ptr is s.val_ptr is s.out_ptr is None
        assert s.capacity == staging.CAPACITY and s.capacity % 4 == 0
        s.launched()
        assert not s.pending
    assert len(ring.slots) == staging.SLOTS


@pytest.mark.parametrize("kw", [dict(device="meta"), dict(capacity=6),
                                dict(capacity=0), dict(slots=0)])
def test_ring_argument_checks(kw):
    kw.setdefault("device", "cpu")
    with pytest.raises((TypeError, ValueError)):
        Ring(**kw)


# ---------------------------------------------------------------------------
# staged calls on CPU tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,n,kind", CASES)
def test_staged_gather_matches_plain_and_reference(rows, n, kind):
    tab, idx, val = staged_inputs(rows, n, kind)
    slot = stage(Ring("cpu"), idx, val)
    got = spec_gather_staged(torch.from_numpy(tab), slot, n)
    assert got.shape == (n,) and got.dtype == np.int32
    assert n == 0 or np.shares_memory(got, slot.out)
    want = ref.spec_gather(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(got, want[:, 0].numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jref.spec_gather(jnp.asarray(tab),
                                         jnp.asarray(idx)))[:, 0])
    if kind == "poison":
        assert not got.any()


@pytest.mark.parametrize("rows,n,kind", CASES)
def test_staged_scatter_matches_plain_and_reference(rows, n, kind):
    tab, idx, val = staged_inputs(rows, n, kind)
    slot = stage(Ring("cpu"), idx, val)
    t = torch.from_numpy(tab.copy())
    assert spec_scatter_add_staged(t, slot, n) is t  # in place
    want = ref.spec_scatter_add(torch.from_numpy(tab.copy()),
                                torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_array_equal(t.numpy(), want.numpy())
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jref.spec_scatter_add(
            jnp.asarray(tab), jnp.asarray(idx), jnp.asarray(val))))
    if kind == "poison":
        np.testing.assert_array_equal(t.numpy(), tab)


def test_staged_scatter_duplicates_add_and_poison_never_commits():
    tab = np.arange(12, dtype=np.int32).reshape(12, 1)
    idx = np.array([2, 2, -1, 2, 19, 0, -1], np.int32)
    val = np.full((7, 1), 5, np.int32)
    slot = stage(Ring("cpu"), idx, val)
    got = spec_scatter_add_staged(torch.from_numpy(tab.copy()), slot, 7)
    want = tab.copy()
    want[2] += 15   # three duplicates add up
    want[11] += 5   # 19 clips to the last row
    want[0] += 5
    np.testing.assert_array_equal(got.numpy(), want)


def test_staged_calls_on_cpu_launch_nothing():
    tab, idx, val = staged_inputs(16, 40, "mixed")
    before = (spec_gather.launches, dict(spec_gather.route_launches),
              spec_scatter_add.launches,
              dict(spec_scatter_add.route_launches))
    slot = stage(Ring("cpu"), idx, val)
    spec_gather_staged(torch.from_numpy(tab), slot, 40)
    spec_scatter_add_staged(torch.from_numpy(tab), slot, 40)
    assert (spec_gather.launches, spec_gather.route_launches,
            spec_scatter_add.launches,
            spec_scatter_add.route_launches) == before
    assert set(spec_gather.route_launches) == {"tensor", "staged"}


@pytest.mark.parametrize("bad", ["table-dtype", "table-float", "table-d",
                                 "table-1d", "table-strided", "too-many",
                                 "negative-n", "empty-table", "meta-device"])
def test_staged_argument_checks(bad):
    t = torch.zeros((4, 1), dtype=torch.int32)
    ring = Ring("cpu", capacity=8)
    n = 3
    if bad == "table-dtype":
        t = t.long()
    elif bad == "table-float":
        t = t.float()
    elif bad == "table-d":
        t = torch.zeros((4, 2), dtype=torch.int32)
    elif bad == "table-1d":
        t = t[:, 0].contiguous()
    elif bad == "table-strided":
        t = torch.zeros((4, 2), dtype=torch.int32)[:, :1]
    elif bad == "too-many":
        n = 9
    elif bad == "negative-n":
        n = -1
    elif bad == "empty-table":
        t = t[:0]
    elif bad == "meta-device":
        t = t.to("meta")
    slot = ring.acquire(3)
    slot.idx[:3] = 0
    with pytest.raises((TypeError, ValueError)):
        spec_gather_staged(t, slot, n)
    with pytest.raises((TypeError, ValueError)):
        spec_scatter_add_staged(t, slot, n)


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["kernels.gather.allpoison",
                                  "kernels.gather.rows",
                                  "kernels.scatter.raise",
                                  "kernels.scatter.allpoison"])
def test_staged_fault_sites_fire_like_the_tensor_route(site):
    """Each site, armed alone at rate 1, does to the staged route what it
    does to the tensor route and to the reference wrappers (interpret
    mode), at the same places."""
    tab, idx, val = staged_inputs(8, 11, "mixed")
    idx = np.clip(idx, -1, 7)  # the Pallas kernels do not clamp above
    results = {}

    def run(name, gather, scatter, mod):
        with mod.armed(mod.FaultPlan({site: 1.0}, seed=1)):
            try:
                results[name] = (np.asarray(gather()).copy(),
                                 np.asarray(scatter()).copy())
            except mod.InjectedFault as e:
                results[name] = e.site

    jt = jnp.asarray(tab)
    run("jax", lambda: jgather(jt, jnp.asarray(idx), block_d=1,
                               interpret=True),
        lambda: jscatter(jt, jnp.asarray(idx), jnp.asarray(val), block_d=1,
                         interpret=True), jfaults)
    run("tensor", lambda: spec_gather(torch.from_numpy(tab),
                                      torch.from_numpy(idx)).numpy(),
        lambda: spec_scatter_add(torch.from_numpy(tab.copy()),
                                 torch.from_numpy(idx),
                                 torch.from_numpy(val)).numpy(), faults)
    ring = Ring("cpu")
    slots = []

    def staged_gather():
        slots.append(stage(ring, idx, val))
        return spec_gather_staged(torch.from_numpy(tab), slots[-1],
                                  11)[:, None]

    def staged_scatter():
        slots.append(stage(ring, idx, val))
        return spec_scatter_add_staged(torch.from_numpy(tab.copy()),
                                       slots[-1], 11).numpy()

    run("staged", staged_gather, staged_scatter, faults)
    assert not faults.ACTIVE and not jfaults.ACTIVE
    if site == "kernels.scatter.raise":
        assert results["jax"] == results["tensor"] == results["staged"] \
            == site
        # it raised before the kernel, with the gather done
        assert len(slots) == 2
        return
    for got, t_want, j_want in zip(results["staged"], results["tensor"],
                                   results["jax"]):
        np.testing.assert_array_equal(got, t_want)
        np.testing.assert_array_equal(got, j_want)
    # allpoison overwrites the slot's own indices, before the kernel
    poisoned = {"kernels.gather.allpoison": 0,
                "kernels.scatter.allpoison": 1}.get(site)
    for i, slot in enumerate(slots):
        want = np.full(11, -1, np.int32) if i == poisoned else idx
        np.testing.assert_array_equal(slot.idx[:11], want)
