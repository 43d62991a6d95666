"""``repro_torch.verify`` — standalone soundness verifier for compiled DAE pairs.

A second, independent static analysis that re-derives the paper's
speculation-soundness preconditions directly from the IR of a
:class:`repro_torch.core.pipeline.CompiledDAE` (and of source
:class:`repro_torch.core.ir.Function` nests), producing structured
:class:`repro_torch.verify.rules.Diag` findings against the frozen rule
registry in :mod:`repro_torch.verify.rules`.

Independence contract: the analysis modules here (``rules``,
``poisonflow``, ``decoupling``, ``mutate``) import **only**
``repro_torch.core`` — never ``repro_torch.codegen`` — so the verifier cannot
inherit a bug from the classifier it audits.  Only the CLI driver
(``repro_torch.verify.__main__``) and the test suite import codegen, to run
the differential cross-check.  ``tests/test_torch_verify.py`` pins the import
boundary.

Entry points:

* :func:`verify_function` — structural/CFG preconditions on a source nest.
* :func:`verify_compiled` — the full pass over a compiled AGU/CU pair.
* ``python -m repro_torch.verify <workload|--all>`` — the workload +
  randprog differential driver.
"""
from __future__ import annotations

from typing import List, Optional

from ..core.cfg import CFGInfo
from ..core.ir import Function
from . import decoupling, poisonflow
from .rules import (REGISTRY_VERSION, RULES, SCHEDULE_RULES, Diag,
                    detail_of, rule_of, soundness, tag)

__all__ = [
    "Diag", "RULES", "SCHEDULE_RULES", "REGISTRY_VERSION", "tag",
    "rule_of", "detail_of", "soundness", "VerifyError",
    "verify_function", "verify_compiled",
]


class VerifyError(RuntimeError):
    """Raised by callers that demand a clean verdict (``verify=True``)."""

    def __init__(self, diags: List[Diag]) -> None:
        """Carry the findings that made the verdict dirty."""
        super().__init__("; ".join(str(d) for d in diags))
        self.diags = list(diags)


def _structural(fn: Function, label: str) -> List[Diag]:
    """C01/C02 on one function: IR well-formedness, reducible CFG."""
    try:
        fn.verify()
    except Exception as e:  # Function.verify raises bare ValueError
        return [Diag("C01-structural-invalid", label, str(e))]
    try:
        CFGInfo(fn)
    except ValueError as e:
        rule = ("C02-irreducible-cfg" if "irreducible" in str(e)
                else "C01-structural-invalid")
        return [Diag(rule, label, str(e))]
    return []


def verify_function(fn: Function) -> List[Diag]:
    """Structural/CFG preconditions on a *source* nest (pre-lowering)."""
    return _structural(fn, f"fn:{fn.name}")


def verify_compiled(compiled, memory: Optional[dict] = None) -> List[Diag]:
    """Run the full soundness pass over one compiled AGU/CU pair.

    Returns the (possibly empty) list of findings; an empty list is a
    clean verdict.  ``memory`` (array name -> ndarray) is optional and
    only gates the dtype rule D05.  Read-only: neither slice is mutated
    and no codegen module is imported.
    """
    agu: Function = compiled.agu
    cu: Function = compiled.cu
    diags = _structural(agu, "agu") + _structural(cu, "cu")
    if diags:
        return diags  # later passes assume analyzable CFGs

    cfg_cu = CFGInfo(cu)
    diags += poisonflow.taint_check(cu, cfg_cu)
    diags += poisonflow.steer_check(cu, cfg_cu)
    diags += poisonflow.match_tokens(agu, cu, cfg_cu)
    diags += decoupling.agu_checks(agu, cu)
    diags += decoupling.chain_dtype_check(cu, cfg_cu, memory)
    return diags
