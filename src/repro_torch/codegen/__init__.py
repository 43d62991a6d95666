"""Executable codegen backend: lower compiled DAE/SPEC slices to kernels.

Turns a :class:`~repro_torch.core.pipeline.CompiledDAE` into executable
code on two targets:

* ``numpy`` — the AGU slice runs ahead of time as a software prefetcher
  (:mod:`repro_torch.codegen.streams`), and the CU slice is emitted as a
  coroutine-free Python/NumPy state machine consuming the precomputed
  address streams (:mod:`repro_torch.codegen.emit`): sends become stream
  appends, ``consume_ld`` stream reads, ``produce_st``/``poison_st``
  masked writes.
* ``torch`` — the same streams feed the CUDA kernel layer
  (:mod:`repro_torch.codegen.torch_backend`): ``spec_gather`` serves
  epoch-batched load values, ``spec_scatter_add`` commits store batches
  with poisoned slots as ``-1`` indices.  The device tables live on
  ``device`` (``cuda`` unless the caller names another); on a CPU device
  the kernel wrappers run their plain PyTorch versions.

On either target the CU half has two execution modes (``cu_mode``,
default ``"auto"``): when :mod:`repro_torch.codegen.analysis` proves the
CU **iteration-uniform** (straight-line per-iteration dataflow after
if-conversion — the post-speculation SPEC shape), the *vectorised* path
(:mod:`repro_torch.codegen.vector`, emission mode ``cu-vector``) runs
whole epochs of iterations as batched array ops with poison as a mask
lane, planned optimistically by the shared epoch scheduler
(:mod:`repro_torch.codegen.epochs`), with segmented-scan RAW forwarding
along associative store-update chains (refusals recorded on
:attr:`CodegenRun.forward_reason`).  On the torch target the decoupled
arrays share **one fused** device table behind base offsets, so an epoch
costs one ``spec_gather`` plus at most one ``spec_scatter_add`` total.
``auto`` vectorises the torch target (whose wall time is per-kernel-call
dominated — epochs amortise it) and keeps the state machine on the numpy
target.  Non-uniform CUs keep the per-element state machine, with the
reason recorded on :class:`CodegenRun.vector_reason`.

When the stream schedule is illegal — a value-dependent AGU (Fig. 1b
loss of decoupling), an op outside the emitters' subset, or a torch
subset violation — :func:`run` falls back to the coupled untimed
interpreter (:mod:`repro_torch.codegen.fallback`), recording the reason;
``strict=True`` raises instead.  A kernel that fails to build or launch
raises :class:`RuntimeError`, which the ladder does not catch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..resilience import faults
from ..resilience.faults import FaultError
from ..resilience.ladder import FailureEvent, Ladder
from .analysis import (AGU_PURE, AGU_SYNC_SAFE, AGU_VALUE_DEP, CodegenError,
                       SliceAnalysis, UniformLoop)
from .analysis import analyze as _analyze_slices
from .emit import compile_mode, emit_source
from .streams import Streams

__all__ = ["AGU_PURE", "AGU_SYNC_SAFE", "AGU_VALUE_DEP", "CU_MODES",
           "CodegenError", "CodegenRun", "FailureEvent", "SliceAnalysis",
           "Streams", "TARGETS", "UniformLoop", "analyze", "emit_source",
           "lower", "run"]

TARGETS = ("numpy", "torch")
#: how the CU half may execute: epoch-batched array ops for
#: iteration-uniform SPEC shapes, or the per-element state machine
CU_MODES = ("auto", "vector", "state-machine")


def analyze(compiled) -> SliceAnalysis:
    """Classify a CompiledDAE for codegen (memoised on the instance).

    The memo is keyed on the *identity of the slices*, not just the
    CompiledDAE object: a pipeline that rewrites ``compiled.agu`` or
    ``compiled.cu`` in place (re-decoupling, vectoriser experiments)
    gets a fresh classification instead of a stale cached one.
    """
    memo = getattr(compiled, "_codegen_analysis", None)
    if memo is not None:
        agu, cu, info = memo
        if agu is compiled.agu and cu is compiled.cu:
            return info
    info = _analyze_slices(compiled)
    try:
        compiled._codegen_analysis = (compiled.agu, compiled.cu, info)
    except AttributeError:
        pass  # non-dataclass stand-ins in tests may forbid attrs
    return info


@dataclass
class CodegenRun:
    """Outcome of one generated-kernel execution."""

    target: str               # what was requested
    target_used: str          # "numpy" | "torch" | "coupled" (fallback)
    analysis: SliceAnalysis
    stats: Dict[str, Any] = field(default_factory=dict)
    #: why the requested target could not run (None when it did)
    fallback_reason: Optional[str] = None
    streams: Optional[Streams] = None
    #: how the CU executed: "vector" | "state-machine" | None (coupled)
    cu_mode: Optional[str] = None
    #: why the vectorised CU did not run (None when it did, or when the
    #: whole target fell back before the CU mode was chosen).  Reason
    #: strings lead with a ``repro_torch.verify.rules`` rule ID
    #: (``"V01-cu-not-uniform: ..."``) — parse with
    #: :func:`repro_torch.verify.rules.rule_of`, human text follows the tag.
    vector_reason: Optional[str] = None
    #: why segmented-scan RAW forwarding was refused (last refusal of the
    #: vector run; None when every hazarded epoch forwarded, when no
    #: epoch hazarded, or when the CU did not run vectorised).  A refusal
    #: is *not* a failure — the epoch degrades to the sound optimistic
    #: cut and, if even that stalls, the run descends the ladder.
    #: Tagged ``"F01-forward-refused: ..."`` like ``vector_reason``.
    forward_reason: Optional[str] = None
    #: every retry/descend the degradation ladder observed on this run
    #: (:class:`~repro_torch.resilience.ladder.FailureEvent`); empty on a
    #: clean first-rung success
    events: List[FailureEvent] = field(default_factory=list)
    #: compile-cache provenance (``compiled.cache_stats``) when the
    #: compiled pair carries one; None otherwise
    cache: Optional[Dict[str, Any]] = None

    @property
    def fell_back(self) -> bool:
        """True when the run landed on the coupled interpreter rung."""
        return self.target_used == "coupled"


def lower(compiled, target: str = "torch") -> Dict[str, Optional[str]]:
    """Emit (without running) the per-slice sources for ``target``.

    Returns ``{"agu": src, "cu": src, "cu_vector": src}``; an entry is
    None when that slice does not lower (the run-time equivalent is the
    coupled fallback — or, for ``cu_vector``, the per-element ``cu``
    state machine).  A value-dependent AGU refuses here too: its emitted
    text would serve sync loads from an initial-memory snapshot the
    running CU invalidates — exactly the silently-wrong kernel the
    backend promises never to hand out.
    """
    if target not in TARGETS:
        raise ValueError(f"unknown codegen target {target!r}")
    cu_mode = "cu-numpy" if target == "numpy" else "cu-jax"
    agu_src = (None if analyze(compiled).agu_class == AGU_VALUE_DEP
               else emit_source(compiled.agu, "agu-stream"))
    return {"agu": agu_src, "cu": emit_source(compiled.cu, cu_mode),
            "cu_vector": emit_source(compiled.cu, "cu-vector")}


def _resolve_device(target: str, device) -> Optional[torch.device]:
    """The torch target's device: ``cuda`` unless named; never a silent
    CPU.  The numpy target takes none."""
    if target != "torch":
        if device is not None:
            raise ValueError(f"target {target!r} takes no device")
        return None
    return resolve_device(device, "torch target")


def run(compiled, memory: Dict[str, np.ndarray],
        params: Optional[Dict[str, Any]] = None, target: str = "torch", *,
        device=None, strict: bool = False,
        cu_mode: str = "auto", max_steps: int = 2_000_000,
        max_retries: int = 1, backoff: float = 0.0,
        forward: bool = True) -> CodegenRun:
    """Execute ``compiled`` against ``memory`` (mutated in place).

    Memory contract matches the reference's ``run_dae``: decoupled arrays
    end in DU state, the rest in CU state.  ``target`` defaults to
    ``"torch"``; the host-only ``"numpy"`` target runs only when named.
    ``device`` places the torch
    target's tables: None means ``cuda``, and with no card that raises
    :class:`RuntimeError` instead of carrying on on the CPU; tests pass
    ``device="cpu"``.  The reference's ``block_n`` (the floor of its
    power-of-two batch padding) is not taken: the torch target's staged
    kernels take each request unpadded.

    ``cu_mode`` picks how the CU half runs once the stream schedule is
    legal: ``"auto"`` resolves per target — the torch target takes the
    vectorised epoch path when the CU is iteration-uniform (its wall
    time is dominated by per-request kernel calls, which epochs
    amortise) and drops to the per-element state machine otherwise (the
    reason lands in ``CodegenRun.vector_reason``); the numpy target
    keeps the state machine.  ``"vector"`` / ``"state-machine"`` pin one
    path on either target (a pinned vector request that cannot run falls
    back to the coupled interpreter like any other refusal).

    ``forward`` (default True) enables segmented-scan RAW forwarding in
    the vectorised CU; ``forward=False`` cuts the epoch on every
    committed hazard.  The last forwarding refusal, if any, lands on
    :attr:`CodegenRun.forward_reason`.

    A target that cannot run descends the degradation ladder
    (:mod:`repro_torch.resilience.ladder`) to the coupled interpreter
    unless ``strict=True``, in which case :class:`CodegenError` is raised
    with ``memory`` untouched.  A *transient* failure
    (:class:`~repro_torch.resilience.faults.FaultError`) is first retried
    on the same rung up to ``max_retries`` times (exponential ``backoff``
    seconds between tries); deterministic refusals descend immediately.
    Every retry/descend is recorded on :attr:`CodegenRun.events`.
    """
    if target not in TARGETS:
        raise ValueError(f"unknown codegen target {target!r}")
    if cu_mode not in CU_MODES:
        raise ValueError(f"unknown cu_mode {cu_mode!r}")
    dev = _resolve_device(target, device)
    info = analyze(compiled)
    params = dict(params or {})
    stream_reason = info.stream_reason

    if strict and stream_reason is not None:
        raise CodegenError(
            f"codegen target {target!r} unavailable: {stream_reason}")

    # rungs for this request: a pinned cu_mode skips the other CU mode
    # (a pinned vector request that fails goes straight to coupled, as
    # before); strict removes the coupled rung entirely
    want_vector = (cu_mode == "vector"
                   or (cu_mode == "auto" and target == "torch"))
    rungs: List[str] = []
    if stream_reason is None:
        if want_vector:
            rungs.append("vector")
        if cu_mode != "vector":
            rungs.append("state-machine")
    if not strict:
        rungs.append("coupled")

    streams_box: Dict[str, Streams] = {}

    def build_streams() -> Streams:
        """Run the AGU slice ahead of time (memoised across rungs)."""
        faults.inject("codegen.streams")
        if "s" not in streams_box:
            agu_make = compile_mode(compiled.agu, "agu-stream")
            if agu_make is None:
                raise CodegenError("AGU slice not lowerable")
            streams_box["s"] = agu_make(memory, dict(params), max_steps)
        return streams_box["s"]

    def attempt(rung: str) -> Dict[str, Any]:
        """Execute one ladder rung end to end; raises descend the ladder."""
        if rung == "coupled":
            from .fallback import run_coupled
            decoupled = getattr(compiled, "decoupled", None) or info.decoupled
            return run_coupled(compiled, memory, set(decoupled), params,
                               max_steps)
        streams = build_streams()
        if rung == "vector":
            from .vector import run_vector
            return run_vector(compiled, memory, params, streams, info,
                              target, device=dev, max_steps=max_steps,
                              forward=forward)
        if target == "numpy":
            cu_make = compile_mode(compiled.cu, "cu-numpy")
            if cu_make is None:
                raise CodegenError("CU slice not lowerable")
            return cu_make(memory, dict(params), streams.ld_clamped,
                           streams.st_addrs, max_steps)
        from .torch_backend import run_torch
        return run_torch(compiled, memory, params, streams, info,
                         device=dev, max_steps=max_steps)

    ladder = Ladder(rungs, max_retries=max_retries, backoff=backoff,
                    catch=(CodegenError, FaultError))
    if stream_reason is not None:
        # the analysis already refused the generated path: record the
        # descent so the run is observable even without an exception
        ladder.events.append(FailureEvent(
            site="", rung="analysis", cause=stream_reason, retries=0,
            outcome="descend"))
    try:
        used, stats = ladder.run(attempt)
    except FaultError as e:
        raise CodegenError(
            f"codegen target {target!r} unavailable: {e}") from e
    except CodegenError as e:
        if strict:
            raise CodegenError(
                f"codegen target {target!r} unavailable: {e}") from e
        raise  # the coupled interpreter's own loud refusal — never silent

    used_cu = None if used == "coupled" else used
    target_used = "coupled" if used == "coupled" else target

    vector_reason: Optional[str] = None
    if cu_mode == "auto":
        for ev in ladder.events:
            if ev.rung == "vector" and ev.outcome == "descend":
                vector_reason = ev.cause
    fallback_reason: Optional[str] = None
    if used == "coupled":
        if stream_reason is not None:
            fallback_reason = stream_reason
        else:
            desc = [ev for ev in ladder.events if ev.outcome == "descend"]
            fallback_reason = desc[-1].cause if desc else None

    forward_reason = (stats.pop("fwd_refusal_reason", None)
                      if isinstance(stats, dict) else None)

    return CodegenRun(target, target_used, info, stats, fallback_reason,
                      streams_box.get("s"), used_cu, vector_reason,
                      forward_reason, ladder.events,
                      cache=getattr(compiled, "cache_stats", None))
