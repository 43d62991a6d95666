"""Persistent compile cache for frontend programs.

Repeat traffic through :meth:`repro_torch.frontend.Program.compile` should
never pay decouple/speculate/poison analysis or source emission twice:
the first compile of a program stores everything the executable backends
derive — the compiled slices, the :class:`~repro_torch.codegen.SliceAnalysis`
memo, the iteration-uniformity memo, and every ``emit_source`` text —
and later compiles of an identical program restore it all from disk.

Key discipline (mirrors the ``codegen.analyze`` memo, which keys on the
identity of the slices rather than the container):

* the **key** is a SHA-256 over the schema stamp, the compile mode, the
  decoupled-array set, and the program's canonical recording text
  (:meth:`Program.signature`) — content, not object identity;
* the **payload** carries the lowered IR dump it was built from.  On a
  warm hit the program is re-lowered (cheap — no analysis) and the dump
  compared: a payload whose key matches but whose IR differs (hash
  collision, hand-edited entry, stale schema inside the file) is
  discarded, recorded as a ``FailureEvent(site="frontend.cache_stale")``,
  and recompiled cold — never silently reused;
* bumping :data:`SCHEMA` (any change to the IR, the transforms, or the
  emitters that alters what a payload means) invalidates every entry,
  because the stamp is inside the key;
* the payload also carries the :mod:`repro_torch.verify` **verdict** (rule
  registry version + diag tuples), so ``compile(..., verify=True)``
  warm hits replay the stored verdict instead of re-running the pass;
  a verdict minted against an older
  :data:`repro_torch.verify.REGISTRY_VERSION` is stale like any other payload
  drift.

The port shares ``DAE_CACHE_DIR`` with the JAX package but never its
entries: its key text carries its own namespace (:data:`NAMESPACE`), so
the same program hashes to another file, and a payload is unpickled by
:class:`_PortUnpickler`, which resolves only this package's, numpy's and
the builtins' classes.  A payload that names any other module (a
reference entry copied under a port key, say) is stale, never imported.
Nothing bound to a device is pickled: the payload holds the slices, the
analysis memos and the emitted source texts, and runners are rebuilt
from the texts on load.

Cache roots: pass ``root=`` explicitly, or set ``DAE_CACHE_DIR`` and let
:func:`resolve_cache` hand out a per-directory singleton; with neither,
``Program.compile`` runs uncached.  Outcome + counters land on
``CompiledDAE.cache_stats`` and ride through to ``CodegenRun.cache``.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Dict, List, Optional, Set

from ..core.pipeline import CompiledDAE
from ..resilience.ladder import FailureEvent

#: bump on any change that alters payload meaning (IR shape, transform
#: semantics, emitted-source conventions); lives inside the key, so old
#: entries simply stop matching
SCHEMA = 1

#: the key text's namespace: the JAX package keys ``dae-frontend/v…``
NAMESPACE = "dae-frontend-torch"

#: top-level modules whose classes a payload may name
_PICKLE_MODULES = frozenset(["repro_torch", "numpy", "builtins"])


class _PortUnpickler(pickle.Unpickler):
    """Unpickler that resolves classes of :data:`_PICKLE_MODULES` only."""

    def find_class(self, module: str, name: str):
        """Refuse a class outside the allowed modules before importing."""
        if module.split(".")[0] not in _PICKLE_MODULES:
            raise pickle.UnpicklingError(
                f"payload names {module}.{name}, outside "
                f"{sorted(_PICKLE_MODULES)}")
        return super().find_class(module, name)


class CompileCache:
    """Disk-backed compile cache; one instance per root directory."""

    def __init__(self, root: Optional[str] = None):
        root = root or os.environ.get("DAE_CACHE_DIR")
        if not root:
            raise ValueError("CompileCache needs a root (argument or "
                             "DAE_CACHE_DIR)")
        self.root = os.path.realpath(root)
        os.makedirs(self.root, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.invalidated = 0
        self.events: List[FailureEvent] = []

    # -- keys ----------------------------------------------------------------
    def key(self, signature: str, decoupled: Set[str], mode: str) -> str:
        """SHA-256 of the namespace, schema, mode, set and signature."""
        text = (f"{NAMESPACE}/v{SCHEMA}\nmode={mode}\n"
                f"decoupled={sorted(decoupled)}\n{signature}")
        return hashlib.sha256(text.encode()).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.pkl")

    # -- the compile wrapper -------------------------------------------------
    def compile(self, program, fn, decoupled: Set[str], mode: str,
                compiler: Callable[..., CompiledDAE],
                verify: bool = False) -> CompiledDAE:
        """Warm-or-cold compile ``program`` (already lowered to ``fn``).

        ``verify=True`` demands a soundness-clean
        :mod:`repro_torch.verify` verdict.  The verdict is computed once per
        cold store and persisted in the payload; warm hits *replay* the
        stored verdict (raising :class:`repro_torch.verify.VerifyError` on
        dirt) without re-running the pass.  A payload whose verdict was
        minted against an older rule-registry version is treated as
        stale — recorded as ``frontend.cache_stale`` and recompiled.
        """
        key = self.key(program.signature(), decoupled, mode)
        dump = fn.dump()
        comp, was_stale = self._load(key, dump, need_verdict=verify)
        if comp is not None:
            self.hits += 1
            comp.cache_stats = self._stats("warm", key)
            if verify:
                self._enforce(comp)
            return comp
        outcome = "stale" if was_stale else "cold"
        if not was_stale:
            self.misses += 1
        comp = compiler(fn, decoupled)
        self._store(key, dump, comp)
        comp.cache_stats = self._stats(outcome, key)
        if verify:
            self._enforce(comp)
        return comp

    # -- store ---------------------------------------------------------------
    def _store(self, key: str, dump: str, comp: CompiledDAE) -> None:
        """Derive everything the backends would and persist it.

        Runs classification + uniformity analysis + all source emission
        *now* so the memo attrs pickled with the slices make the warm
        path analysis-free.  Runner functions themselves are never
        pickled — they are rebuilt from the cached source texts by
        :func:`repro_torch.codegen.emit.preload_source` at load time.
        """
        from .. import codegen
        from ..codegen import AGU_VALUE_DEP
        from ..codegen.emit import MODES, emit_source

        from .. import verify as verify_mod

        info = codegen.analyze(comp)  # attaches the _codegen_analysis memo
        sources: Dict[str, Optional[str]] = {
            "agu-stream": (None if info.agu_class == AGU_VALUE_DEP
                           else emit_source(comp.agu, "agu-stream")),
        }
        for m in MODES[1:]:
            sources[m] = emit_source(comp.cu, m)  # memoises _codegen_uniform
        # verdict rides in the payload (not the key): a registry bump
        # makes the verdict stale without invalidating the whole entry
        # namespace, and warm verify=True hits replay it for free
        verdict = {"registry": verify_mod.REGISTRY_VERSION,
                   "diags": [(d.rule, d.site, d.detail)
                             for d in verify_mod.verify_compiled(comp)]}
        comp._verify_verdict = verdict  # type: ignore[attr-defined]
        payload = {"schema": SCHEMA, "dump": dump,
                   "compiled": comp, "sources": sources,
                   "verdict": verdict}
        tmp = self._path(key) + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            pickle.dump(payload, fh)
        os.replace(tmp, self._path(key))

    # -- load ----------------------------------------------------------------
    def _load(self, key: str, expect_dump: str, need_verdict: bool = False):
        """Returns ``(compiled_or_None, was_stale)``."""
        from ..codegen.emit import preload_source

        path = self._path(key)
        if not os.path.exists(path):
            return None, False
        try:
            with open(path, "rb") as fh:
                payload = _PortUnpickler(fh).load()
            if payload.get("schema") != SCHEMA:
                raise _Stale(f"schema {payload.get('schema')!r} != {SCHEMA}")
            if payload.get("dump") != expect_dump:
                raise _Stale("re-lowered IR differs from cached payload")
            if need_verdict:
                from ..verify import REGISTRY_VERSION
                v = payload.get("verdict")
                if not v or v.get("registry") != REGISTRY_VERSION:
                    raise _Stale(
                        f"verifier verdict "
                        f"{'missing' if not v else 'v%r' % v.get('registry')}"
                        f" != registry v{REGISTRY_VERSION}")
            comp = payload["compiled"]
            comp._verify_verdict = payload.get("verdict")
            sources = payload["sources"]
        except Exception as e:  # corrupt or foreign pickle, schema, IR drift
            self.stale += 1
            ev = FailureEvent(site="frontend.cache_stale", rung="cache",
                              cause=str(e), retries=0, outcome="descend")
            ev.meta_key = key  # type: ignore[attr-defined]
            self.events.append(ev)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None, True
        for m, src in sources.items():
            preload_source(comp.agu if m == "agu-stream" else comp.cu,
                           m, src)
        return comp, False

    # -- verification --------------------------------------------------------
    def _enforce(self, comp: CompiledDAE) -> None:
        """Replay the stored verdict; raise on soundness findings."""
        from .. import verify as verify_mod

        verdict = comp._verify_verdict  # type: ignore[attr-defined]
        diags = [verify_mod.Diag(*t) for t in verdict["diags"]]
        bad = verify_mod.soundness(diags)
        if bad:
            raise verify_mod.VerifyError(bad)

    # -- invalidation --------------------------------------------------------
    def clear(self) -> int:
        """Drop every entry under the root; returns the count removed."""
        n = 0
        for name in os.listdir(self.root):
            if name.endswith(".pkl"):
                try:
                    os.unlink(os.path.join(self.root, name))
                    n += 1
                except OSError:
                    pass
        self.invalidated += n
        return n

    def invalidate(self, program, decoupled: Set[str],
                   mode: str = "spec") -> bool:
        """Drop one program's entry; returns whether one was removed."""
        path = self._path(self.key(program.signature(), decoupled, mode))
        try:
            os.unlink(path)
        except OSError:
            return False
        self.invalidated += 1
        return True

    # -- observability -------------------------------------------------------
    def _stats(self, outcome: str, key: str) -> Dict[str, Any]:
        stats: Dict[str, Any] = {
            "outcome": outcome, "key": key, "root": self.root,
            "hits": self.hits, "misses": self.misses, "stale": self.stale,
            "invalidated": self.invalidated}
        if outcome == "stale":
            stats["events"] = [ev for ev in self.events
                               if getattr(ev, "meta_key", None) == key]
        return stats


class _Stale(RuntimeError):
    """Internal: a cache payload that must not be reused."""


# -- ambient default ---------------------------------------------------------

_DEFAULTS: Dict[str, CompileCache] = {}


def resolve_cache(arg: Any) -> Optional[CompileCache]:
    """``False`` → off; an instance → itself; ``None`` → the ambient
    per-``DAE_CACHE_DIR`` singleton (or off when the env var is unset)."""
    if arg is False:
        return None
    if isinstance(arg, CompileCache):
        return arg
    if arg is not None:
        raise TypeError(f"cache must be a CompileCache, None or False, "
                        f"not {type(arg).__name__}")
    root = os.environ.get("DAE_CACHE_DIR")
    if not root:
        return None
    root = os.path.realpath(root)
    if root not in _DEFAULTS:
        _DEFAULTS[root] = CompileCache(root)
    return _DEFAULTS[root]
