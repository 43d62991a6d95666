"""Deterministic, seedable fault-injection plane for the DAE stack.

The paper's poison discipline — speculate freely, poison mis-speculated
requests, never commit or replay a wrong value — is a *fault-containment
contract*.  This module makes the containment testable: named injection
sites threaded through the codegen runtime, the Pallas kernel wrappers
and the serving engine fire deterministic faults when a
:class:`FaultPlan` is armed, and compile to near-no-ops (one global
``bool`` check) when nothing is armed, so the hot path pays nothing.

Determinism model: every site gets its own :class:`random.Random` seeded
from ``crc32(site) ^ plan.seed``, and every *query* of a site advances
that stream — rate draws are made even when a cap (``max_fires``,
``after``) suppresses the fire, so the k-th query of a site fires
identically regardless of what other sites did.  ``DAE_TEST_SEED``
(shared with the test suite, see ``tests/conftest.py``) is the default
seed, so a chaos failure reproduces from the seed alone.

Arming:

* programmatic — ``with faults.armed(FaultPlan({"serve.slot": 1.0}))``;
* environment — ``DAE_FAULT_PLAN="codegen.vector.epoch=0.5,serve.*=0.1"``
  arms a plan at import (bare site name means rate 1.0; ``fnmatch``
  globs expand against :data:`SITES`).

Faults come in two flavours, both rooted at :class:`FaultError` so the
degradation ladder (:mod:`repro.resilience.ladder`) can classify them as
*transient* (retryable) as opposed to deterministic refusals:

* :class:`InjectedFault` — the plan said "die here" (raised exception,
  dropped heartbeat, dying serve slot);
* :class:`FaultDetected` — an integrity check caught corrupted data
  (e.g. a gather that returned wrong rows) *before* commit.  Data
  corruption is only ever injected where an independent replica exists
  to detect it — the no-silent-commit invariant is absolute.
"""
from __future__ import annotations

import fnmatch
import os
import random
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["SITES", "CORRUPTION_SITES", "FaultError", "InjectedFault",
           "FaultDetected", "FaultRecord", "FaultPlan", "ACTIVE", "arm",
           "disarm", "armed", "current", "fire", "inject", "corrupting",
           "plan_from_env"]

#: every named injection site in the stack.  Plans resolve their glob
#: patterns against this tuple, so a typo in a pattern is a loud error
#: instead of a silently-unarmed site.
SITES = (
    # codegen runtime
    "codegen.streams",          # AGU stream build raises mid-prefetch
    "codegen.vector.epoch",     # vector driver dies at an epoch commit
    "codegen.jax.refill",       # state-machine refill raises mid-epoch
    "codegen.jax.flush",        # state-machine store flush raises
    "codegen.coupled",          # even the coupled interpreter dies
    # Pallas kernel wrappers
    "kernels.gather.rows",      # gather returns corrupted rows
    "kernels.gather.allpoison", # every request poisoned (all -1)
    "kernels.scatter.allpoison",# whole store batch dropped at commit
    "kernels.scatter.raise",    # scatter raises mid-epoch
    # serving engine
    "serve.slot",               # one slot dies during a wave
    "serve.decode",             # a decode step times out
    "serve.storm",              # request storm: queue doubles mid-run
    # fleet policy engine (train/fault.py consumes these signals)
    "train.heartbeat",          # a host's heartbeat is dropped
    "train.straggler",          # a host's step time is inflated
)

#: sites that *silently corrupt data* rather than raise.  The codegen
#: drivers maintain shadow replicas + verify-before-commit barriers only
#: when the armed plan can actually fire one of these (rate > 0) — the
#: detection machinery is itself a measurable cost, and an armed plan
#: targeting only raise-sites doesn't need it.
CORRUPTION_SITES = ("kernels.gather.rows", "kernels.gather.allpoison",
                    "kernels.scatter.allpoison")


class FaultError(RuntimeError):
    """Root of the injected/detected fault hierarchy.

    Distinct from :class:`~repro.codegen.analysis.CodegenError` on
    purpose: the ladder retries ``FaultError`` (transient) before
    descending, while a ``CodegenError`` is a deterministic refusal that
    descends immediately — retrying it would only repeat the refusal.
    """

    def __init__(self, site: str, msg: str):
        super().__init__(msg)
        self.site = site


class InjectedFault(FaultError):
    """A fault the armed plan chose to fire (simulated runtime death)."""

    def __init__(self, site: str, msg: str = "", rid: Optional[int] = None):
        super().__init__(site, msg or f"injected fault at {site}")
        self.rid = rid  # serving: which request the fault poisoned


class FaultDetected(FaultError):
    """An integrity check caught corrupted data before commit."""


@dataclass
class FaultRecord:
    """One fired fault (for assertions and post-mortems)."""

    site: str
    call: int  # which query of this site fired (0-based)


@dataclass
class FaultPlan:
    """Deterministic per-site fire schedule.

    ``rates`` maps site patterns (exact names or ``fnmatch`` globs over
    :data:`SITES`) to fire probabilities in ``[0, 1]``.  ``max_fires``
    caps total fires across all sites; ``after`` skips the first N
    queries of every site (lets a driver commit real work before dying —
    the "fails after a committed epoch" scenario).
    """

    rates: Dict[str, float]
    seed: Optional[int] = None
    max_fires: Optional[int] = None
    after: int = 0
    fired: List[FaultRecord] = field(default_factory=list)

    def __post_init__(self):
        if self.seed is None:
            self.seed = _env_seed()
        resolved: Dict[str, float] = {}
        for pat, rate in self.rates.items():
            hits = fnmatch.filter(SITES, pat)
            if not hits:
                raise ValueError(
                    f"fault pattern {pat!r} matches no known site "
                    f"(see resilience.faults.SITES)")
            if not (0.0 <= float(rate) <= 1.0):
                raise ValueError(f"fault rate for {pat!r} out of [0,1]")
            for s in hits:
                resolved[s] = float(rate)
        self._rates = resolved
        self._rng = {s: random.Random(zlib.crc32(s.encode()) ^ self.seed)
                     for s in resolved}
        self._calls = {s: 0 for s in resolved}

    def should_fire(self, site: str) -> bool:
        rate = self._rates.get(site)
        if not rate:
            # unlisted or rate-0.0: can never fire, and per-site RNG
            # streams are independent, so skipping the draw cannot
            # perturb any site that can — keep the quiet path cheap
            return False
        call = self._calls[site]
        self._calls[site] = call + 1
        # draw unconditionally so the k-th query of a site is identical
        # no matter which caps were in force on earlier queries
        hit = self._rng[site].random() < rate
        if not hit or call < self.after:
            return False
        if self.max_fires is not None and len(self.fired) >= self.max_fires:
            return False
        self.fired.append(FaultRecord(site, call))
        return True

    def corrupts(self) -> bool:
        """True when this plan can fire a silent-corruption site."""
        return any(self._rates.get(s) for s in CORRUPTION_SITES)


# --------------------------------------------------------------------------
# module-level arming (the one-global-check hot path)
# --------------------------------------------------------------------------

ACTIVE: bool = False
_PLAN: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the active plan (returns it for chaining)."""
    global ACTIVE, _PLAN
    _PLAN = plan
    ACTIVE = True
    return plan


def disarm() -> None:
    global ACTIVE, _PLAN
    _PLAN = None
    ACTIVE = False


@contextmanager
def armed(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block (restores the previous
    plan on exit, so tests can nest)."""
    global ACTIVE, _PLAN
    prev = _PLAN
    arm(plan)
    try:
        yield plan
    finally:
        if prev is None:
            disarm()
        else:
            arm(prev)


def current() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str) -> bool:
    """True when the armed plan fires at ``site`` (False when unarmed).

    Call sites guard with ``if faults.ACTIVE and faults.fire(site):`` so
    the unarmed cost is one module-global bool check.
    """
    if _PLAN is None:
        return False
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}")
    return _PLAN.should_fire(site)


def inject(site: str) -> None:
    """Raise :class:`InjectedFault` when the plan fires at ``site``."""
    if _PLAN is None:
        return
    if _PLAN.should_fire(site):
        raise InjectedFault(site)


def corrupting() -> bool:
    """True when the armed plan can silently corrupt data (and the
    drivers must therefore maintain their shadow replicas)."""
    return _PLAN is not None and _PLAN.corrupts()


# --------------------------------------------------------------------------
# environment arming
# --------------------------------------------------------------------------


def _env_seed() -> int:
    raw = os.environ.get("DAE_TEST_SEED", "")
    if not raw:
        return 0xDAE
    try:
        return int(raw, 0)
    except ValueError:
        raise ValueError(f"DAE_TEST_SEED={raw!r} is not an integer") from None


def plan_from_env(spec: Optional[str] = None) -> Optional[FaultPlan]:
    """Parse ``DAE_FAULT_PLAN`` (``site=rate,glob.*=rate,...``; a bare
    site name means rate 1.0).  Returns None when unset/empty."""
    if spec is None:
        spec = os.environ.get("DAE_FAULT_PLAN", "")
    spec = spec.strip()
    if not spec:
        return None
    rates: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            pat, _, val = part.partition("=")
            try:
                rates[pat.strip()] = float(val)
            except ValueError:
                raise ValueError(
                    f"DAE_FAULT_PLAN: bad rate in {part!r}") from None
        else:
            rates[part] = 1.0
    return FaultPlan(rates) if rates else None


_env_plan = plan_from_env()
if _env_plan is not None:
    arm(_env_plan)
del _env_plan
