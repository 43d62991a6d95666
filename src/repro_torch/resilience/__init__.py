"""Fault injection + graceful degradation for the DAE execution stack.

Two halves (deliberately dependency-free so every layer — codegen,
kernels, serve, train — can import them without cycles):

* :mod:`repro.resilience.faults` — deterministic, seedable fault plane
  (:class:`FaultPlan`) with named injection sites that are no-ops when
  no plan is armed;
* :mod:`repro.resilience.ladder` — the explicit degradation ladder
  (bounded retry + backoff per rung, :class:`FailureEvent` taxonomy)
  enforcing the no-silent-commit invariant.
"""
from . import faults
from .faults import (FaultDetected, FaultError, FaultPlan, FaultRecord,
                     InjectedFault, SITES, plan_from_env)
from .ladder import FailureEvent, Ladder

__all__ = ["faults", "FaultDetected", "FaultError", "FaultPlan",
           "FaultRecord", "InjectedFault", "SITES", "plan_from_env",
           "FailureEvent", "Ladder"]
