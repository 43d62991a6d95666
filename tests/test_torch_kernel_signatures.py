"""The ctypes bindings of the port's CUDA kernels against their C sources,
on the CPU (nothing is compiled).

``repro_torch.kernels.build.SIGNATURES`` declares, for every library
built from ``src/repro_torch/kernels/csrc/<name>.cu``, the argument types
ctypes passes to each exported C entry.  A declaration that disagrees
with the source's prototype passes a pointer as a 32-bit int, or shifts
every argument after a missing one, and nothing on the card reports it.
So each entry's prototype is read from its source (macro-generated
entries through their macro's instances) and held to its declaration,
argument by argument, and every ``extern "C"`` entry of a source is
declared.
"""
from __future__ import annotations

import ctypes
import re

import pytest

from repro_torch.kernels import build

#: the C parameter types the entries use, as ctypes passes them
C_TYPES = {"pointer": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int64_t": ctypes.c_longlong, "int": ctypes.c_int}


def _source(name: str) -> str:
    """``csrc/<name>.cu`` without comments, macro lines joined."""
    text = (build.SRC_DIR / f"{name}.cu").read_text()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return text.replace("\\\n", " ")


def _params(text: str, start: int) -> list:
    """The comma-separated parameters of the parenthesis opening at
    ``start``."""
    depth, i = 0, start
    while True:
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        if depth == 0:
            break
        i += 1
    inner = text[start + 1:i].strip()
    return [p.strip() for p in inner.split(",")] if inner else []


def _kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    words = param.split()[:-1]  # drop the parameter's name
    words = [w for w in words if w != "const"]
    return " ".join(words)


def _entries(name: str) -> dict:
    """Each ``extern "C"`` entry of ``csrc/<name>.cu``: its parameter
    kinds, the entries a macro defines under the names its instances
    give."""
    text = _source(name)
    macros = {}
    for m in re.finditer(r"#define\s+(\w+)\(([^)]*)\)([^\n]*)", text):
        if 'extern "C"' in m.group(3):
            macros[m.group(1)] = ([a.strip() for a in m.group(2).split(",")],
                                  m.group(3))
    found = {}
    plain = re.sub(r"#define[^\n]*", " ", text)
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(', plain):
        found[m.group(1)] = [_kind(p) for p in _params(plain, m.end() - 1)]
    for macro, (args, body) in macros.items():
        m = re.search(r'extern\s+"C"\s+int\s+(\w+)\s*\(', body)
        kinds = [_kind(p) for p in _params(body, m.end() - 1)]
        slot = args.index(m.group(1))
        for call in re.finditer(rf"^\s*{macro}\(([^)]*)\)", plain, flags=re.M):
            found[call.group(1).split(",")[slot].strip()] = kinds
    return found


ENTRIES = [(lib, fn) for lib in build.SIGNATURES for fn in build.SIGNATURES[lib]]


@pytest.mark.parametrize("lib,fn", ENTRIES)
def test_declared_arguments_match_the_prototype(lib, fn):
    """The entry exists in its library's source, takes as many arguments
    as declared, and each declared ctypes type is the one the C type
    needs (a pointer as ``c_void_p``, ``long long`` / ``int64_t`` as
    ``c_longlong``, ``int`` as ``c_int``)."""
    kinds = _entries(lib).get(fn)
    assert kinds is not None, f"{fn} is not an extern \"C\" entry of {lib}.cu"
    declared = build.SIGNATURES[lib][fn]
    assert len(declared) == len(kinds), (fn, kinds)
    for i, (want, kind) in enumerate(zip(declared, kinds)):
        assert kind in C_TYPES, (fn, i, kind)
        assert want is C_TYPES[kind], (fn, i, kind, want)


@pytest.mark.parametrize("lib", sorted(build.SIGNATURES))
def test_every_entry_of_a_source_is_declared(lib):
    """No ``extern "C"`` entry of a built source goes undeclared (ctypes
    would pass its arguments as 32-bit ints), and each source is one
    library of ``build.SIGNATURES``."""
    assert (build.SRC_DIR / f"{lib}.cu").exists()
    assert sorted(_entries(lib)) == sorted(build.SIGNATURES[lib])


def test_every_source_is_built():
    """Every ``csrc/*.cu`` is a library the build compiles."""
    sources = sorted(p.stem for p in build.SRC_DIR.glob("*.cu"))
    assert sources == sorted(build.SIGNATURES)


@pytest.mark.parametrize("t", ["f32", "bf16"])
def test_mamba_backward_entries_take_the_same_arguments(t):
    """The Mamba step pair's backward entry takes what the chunk route's
    takes (a workspace of unit boundaries and partial sums, then du, the
    column sums of dB, dC and ddelta, da and ds0): the wrappers call both
    through one launcher."""
    kinds = _entries("mamba_scan")
    assert kinds[f"mamba_scan_bwd_{t}"] == kinds[f"mamba_scan_bwd_chunk_{t}"]
    assert len(build.SIGNATURES["mamba_scan"][f"mamba_scan_bwd_{t}"]) == 18
