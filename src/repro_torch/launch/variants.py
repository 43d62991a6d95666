"""Build variants of a shipped kernel source, for timing scripts.

A variant is the shipped ``csrc/<lib>.cu`` with a few replacements of its
text, each of which must match exactly once, so a script builds what it
says as the source moves.  Each variant compiles with the kernels' own
flags beside the shared headers into ``build/variants/`` (a library's
name hashes its text, the headers and the flags, as
:func:`repro_torch.kernels.build.library_path` does), all in parallel,
and loads with the shipped library's C entries.
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess

from repro_torch.kernels import build


def source(lib: str, subs) -> str:
    """``csrc/<lib>.cu`` with each ``(old, new)`` of ``subs`` replaced;
    raises unless each ``old`` is found once."""
    text = (build.SRC_DIR / f"{lib}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{lib}.cu: {old!r} found "
                               f"{text.count(old)} times, want once")
        text = text.replace(old, new)
    return text


def _key(text: str) -> str:
    return hashlib.sha256(text.encode() + b"".join(
        h.read_bytes() for h in sorted(build.SRC_DIR.glob("*.cuh")))
        + " ".join(build.FLAGS).encode()).hexdigest()[:16]


def library_path(lib: str, subs):
    """Where :func:`build_all` puts the library of ``lib`` with ``subs``."""
    return (build.BUILD_DIR.parent / "variants"
            / f"lib{lib}-{_key(source(lib, subs))}.so")


def build_all(lib: str, variants: dict) -> dict:
    """Each variant's library (``variants``: name -> replacements), built
    in parallel beside the kernels', loaded with ``lib``'s entries."""
    out_dir = build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, subs in variants.items():
        text = source(lib, subs)
        key = _key(text)
        src_dir = out_dir / f"src-{key}"
        src_dir.mkdir(exist_ok=True)
        for h in build.SRC_DIR.glob("*.cuh"):
            shutil.copy(h, src_dir / h.name)
        (src_dir / f"{lib}.cu").write_text(text)
        path = out_dir / f"lib{lib}-{key}.so"
        proc = None
        if not path.exists():
            proc = subprocess.Popen(
                [build._nvcc(), *build.FLAGS, "-o", str(path),
                 str(src_dir / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, path)
    libs = {}
    for name, (proc, path) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            print(f"[build] {name}: " + " ".join(
                ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln))
        cdll = ctypes.CDLL(str(path))
        for fn, argtypes in build.SIGNATURES[lib].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
