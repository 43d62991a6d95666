"""Stable rule registry and structured diagnostic type for ``repro_torch.verify``.

Every finding the verifier (or the codegen classifier, via the tagging
helpers below) can produce is a :class:`Diag` carrying a *rule ID* from
the frozen :data:`RULES` table.  Rule IDs are part of the repo's public
surface: tests, reason-string consumers (``rule_of``) and
``docs/verify.md`` all key on them, so IDs are append-only — never renumber.

The registry is grouped by prefix:

* ``C``  — structural/CFG preconditions on any slice
* ``P``  — poison-flow soundness (taint, steering, request/token matching)
* ``D``  — decoupling translation validation (AGU purity, fences, chains)
* ``V``  — vector-lowering refusals (tags for ``codegen``'s own reasons)
* ``F``  — forwarding refusals (tags for ``codegen``'s own reasons)
* ``X``  — meta findings (verifier vs. classifier differential splits)

``C``/``P``/``D`` rules are *emitted by the verifier*; ``V``/``F`` exist so
``codegen`` reason strings carry machine-stable IDs (satellite: reason
unification) without the verifier ever importing ``codegen``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

#: bumped whenever rule semantics change — cached verdicts keyed on an
#: older version are stale (see ``repro_torch.frontend.cache``)
REGISTRY_VERSION = 1

#: rule ID -> one-line precondition it checks (the human contract;
#: docs/verify.md carries the full table with paper sections)
RULES = {
    "C01-structural-invalid":
        "slice passes Function.verify() (defs precede uses, phis match preds)",
    "C02-irreducible-cfg":
        "every retreating edge is a back edge (reducible CFG; paper §4.1)",
    "C03-unsupported-shape":
        "program shape is within the verifier's proven coverage",
    "P01-poison-escapes-commit":
        "no speculatively-loaded value reaches an architectural write "
        "outside the control region of a speculation-validating branch",
    "P02-request-unresolved":
        "on every feasible iteration path, AGU requests and CU tokens "
        "match one-to-one per array (every send answered exactly once)",
    "P03-steer-discipline":
        "every steering flag is reset (imm 0) in the governing loop header "
        "and set (imm 1) on exactly the speculative paths that read it",
    "D01-agu-value-dependent":
        "the AGU slice is pure-address or sync-read-only: no sync load "
        "of an array the loop also stores",
    "D02-sync-flag-mismatch":
        "recorded send_ld sync flags equal the recomputed AGU use-set "
        "(finalize_agu's contract, re-derived independently)",
    "D03-epoch-fence-violated":
        "per-array token order equals request order on every feasible "
        "path (gather_limit's fence premise; paper §5.2)",
    "D04-chain-illegal":
        "a claimed forwarding chain has a single store slot and a pure "
        "'+' spine rooted at exactly one chain load (paper §5.2 ext.)",
    "D05-chain-dtype":
        "forwarding chains ride integral arrays only (float '+' is not "
        "associative enough for segmented-scan re-association)",
    "V01-cu-not-uniform":
        "CU is iteration-uniform (codegen vector classifier refusal tag)",
    "V02-epoch-stalled":
        "no committed same-epoch RAW stalls the optimistic window "
        "(codegen runtime refusal tag)",
    "V03-lane-overflow":
        "int64 lane arithmetic cannot overflow a commit "
        "(codegen runtime refusal tag)",
    "V04-stream-underrun":
        "AGU streams cover every CU token (codegen runtime refusal tag)",
    "V05-op-not-lowerable":
        "every op in the slice has a lowering (codegen refusal tag)",
    "F01-forward-refused":
        "RAW forwarding preconditions hold (codegen refusal tag)",
    "X01-verifier-classifier-split":
        "verifier and codegen classifier agree on legality "
        "(differential cross-check finding)",
}

#: rules that refuse a *schedule*, not the program: the IR is legal, but
#: codegen must not run the corresponding fast path (stream-ahead for
#: D01, segmented-scan forwarding for D05).  The differential cross-check
#: demands codegen's classifier agrees; the soundness gate
#: (:func:`soundness`) excludes them — a value-dependent AGU is a valid
#: program that simply runs coupled.
SCHEDULE_RULES = frozenset({
    "D01-agu-value-dependent",
    "D05-chain-dtype",
})

_RULE_RE = re.compile(r"^([CPDVFX]\d{2}-[a-z0-9-]+):\s")


def soundness(diags):
    """Filter a finding list down to genuine soundness violations."""
    return [d for d in diags if d.rule not in SCHEDULE_RULES]


@dataclass(frozen=True)
class Diag:
    """One structured finding: a rule ID, where it fired, and the detail.

    ``rule`` is a key of :data:`RULES`; ``site`` names the slice/block/
    instruction the finding anchors to (e.g. ``"cu:poison.b2.latch"``);
    ``detail`` is the human sentence (the old ad-hoc reason text).
    """

    rule: str
    site: str
    detail: str

    def __post_init__(self) -> None:
        """Reject diags minted against unknown rule IDs."""
        if self.rule not in RULES:
            raise KeyError(f"unknown verify rule {self.rule!r}")

    def __str__(self) -> str:
        """Render as ``rule @site: detail`` (stable, greppable)."""
        return f"{self.rule} @{self.site}: {self.detail}"


def tag(rule: str, detail: str) -> str:
    """Prefix a human reason string with a registry rule ID.

    The result (``"D01-agu-value-dependent: AGU is value-dependent: ..."``)
    keeps the original text intact as a suffix, so existing substring
    assertions and bench-derived greps keep working while new consumers
    can key on :func:`rule_of`.
    """
    if rule not in RULES:
        raise KeyError(f"unknown verify rule {rule!r}")
    return f"{rule}: {detail}"


def rule_of(text: str | None) -> str | None:
    """Extract the leading rule ID from a tagged reason string, if any."""
    if not text:
        return None
    m = _RULE_RE.match(text)
    return m.group(1) if m else None


def detail_of(text: str | None) -> str | None:
    """Strip the leading rule ID from a tagged reason string, if any."""
    if text is None:
        return None
    m = _RULE_RE.match(text)
    return text[m.end():] if m else text
