"""Explicit degradation ladder: bounded retry, then descend a rung.

The codegen backend already *had* an implicit ladder — vector CU →
per-element state machine → coupled interpreter — expressed as nested
``try/except CodegenError``.  This module promotes it to an explicit,
observable policy object shared by the codegen runtime and the serving
engine, mirroring the ARM big.LITTLE DAE result that *runtime switching
between decoupled and coupled execution is itself the robustness
mechanism*:

* each **rung** is a named attempt at the same work (the attempt
  callable receives the rung name and returns the result);
* a **transient** failure (:class:`~repro.resilience.faults.FaultError`:
  an injected death or detected corruption) is retried on the same rung
  up to ``max_retries`` times with exponential backoff — the fault plane
  is probabilistic, so the same rung may well succeed;
* any other caught failure (a deterministic
  :class:`~repro.codegen.analysis.CodegenError` refusal) **descends**
  immediately — retrying a refusal only repeats it;
* the last rung re-raises.  Combined with every rung's
  mutate-only-on-success discipline this gives the hard invariant: a
  fault either completes bit-identical on a lower rung or raises with
  memory untouched — no silently wrong commit, ever.

Every retry/descend/raise is recorded as a :class:`FailureEvent` on
``Ladder.events``; callers surface the list on their run record
(``CodegenRun.events``, ``Engine.events``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple

from .faults import FaultError

__all__ = ["FailureEvent", "Ladder"]


@dataclass
class FailureEvent:
    """One observed failure and what the ladder did about it."""

    site: str      # fault site, or "" when the failure carried none
    rung: str      # which rung failed ("vector", "state-machine", ...)
    cause: str     # stringified exception
    retries: int   # retries already spent on this rung when this happened
    outcome: str   # "retry" | "descend" | "raise" (engine adds "failed")

    @property
    def rule(self) -> "str | None":
        """Verify-registry rule ID leading ``cause``, when tagged.

        Codegen refusal messages carry ``repro.verify.rules`` IDs
        (``V01-cu-not-uniform: ...``); fault-injection causes do not, so
        this returns ``None`` for them.
        """
        from ..verify.rules import rule_of
        return rule_of(self.cause)


class Ladder:
    """Run ``attempt(rung)`` down ``rungs`` with bounded retry per rung."""

    def __init__(self, rungs: Sequence[str], *, max_retries: int = 1,
                 backoff: float = 0.0,
                 transient: Tuple[type, ...] = (FaultError,),
                 catch: Tuple[type, ...] = (Exception,),
                 sleep: Callable[[float], None] = time.sleep):
        if not rungs:
            raise ValueError("ladder needs at least one rung")
        self.rungs = list(rungs)
        self.max_retries = max_retries
        self.backoff = backoff
        self.transient = transient
        self.catch = catch
        self.sleep = sleep
        self.events: List[FailureEvent] = []

    def _record(self, exc: BaseException, rung: str, retries: int,
                outcome: str) -> None:
        self.events.append(FailureEvent(
            site=getattr(exc, "site", ""), rung=rung, cause=str(exc),
            retries=retries, outcome=outcome))

    def run(self, attempt: Callable[[str], object]):
        """Returns ``(rung, result)`` of the first rung that succeeds."""
        last = len(self.rungs) - 1
        for i, rung in enumerate(self.rungs):
            retries = 0
            while True:
                try:
                    return rung, attempt(rung)
                except self.catch as e:
                    transient = isinstance(e, self.transient)
                    if transient and retries < self.max_retries:
                        self._record(e, rung, retries, "retry")
                        retries += 1
                        if self.backoff > 0:
                            self.sleep(self.backoff * (2 ** (retries - 1)))
                        continue
                    if i == last:
                        self._record(e, rung, retries, "raise")
                        raise
                    self._record(e, rung, retries, "descend")
                    break
        raise AssertionError("unreachable")  # pragma: no cover
