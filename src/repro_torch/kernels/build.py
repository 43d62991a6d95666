"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``build/kernels/`` at the
root of the checkout.  The library's name carries a hash of the source and
the flags, so an edited source rebuilds and a stale library is never
loaded.  The library is written under a temporary name and renamed into
place, so concurrent first uses never load a half-written file.

A failed build raises :class:`RuntimeError` — never a codegen refusal, so
the degradation ladder cannot quietly finish a run on the interpreter
because a kernel did not compile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
#: exported C entry -> argument types; every entry returns a CUDA error
#: code as an int (0 on success)
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    # table, idx, out; rows, n, d; stream
    "spec_gather": {
        "spec_gather_i32": (_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR),
        "spec_gather_f32": (_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR),
        "spec_gather_bf16": (_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR),
        # table, idx, out (mapped); rows, n; stream, device, wait
        "spec_gather_staged_i32": (_PTR,) * 3 + (_I64,) * 2 + (_PTR, _INT,
                                                               _INT),
        # host address, where to write its device address
        "spec_staging_device_ptr": (_PTR, _PTR),
        # measurement only: table, idx, out (pinned), idx, out (device);
        # rows, n; stream, device
        "spec_gather_copied_i32": (_PTR,) * 5 + (_I64,) * 2 + (_PTR, _INT),
        # measurement only: mapped int32 or null; stream, device
        "spec_staging_floor": (_PTR, _PTR, _INT),
    },
    # table, idx, values; rows, n, d; stream
    "spec_scatter": {
        "spec_scatter_add_i32": (_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR),
        "spec_scatter_add_f32": (_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR),
        "spec_scatter_add_bf16": (_PTR, _PTR, _PTR, _I64, _I64, _I64,
                                  _PTR),
        # table, idx, values (mapped); rows, n; stream, event, device
        "spec_scatter_add_staged_i32": (_PTR,) * 3 + (_I64,) * 2 + (
            _PTR, _PTR, _INT),
    },
    # x, w, out; E, capacity, D, F; stream
    "ragged_matmul": {
        f"ragged_matmul_{t}": (_PTR,) * 3 + (_I64,) * 4 + (_PTR,)
        for t in ("f32", "bf16")
    },
    # q, k, v, out; B*H, tq, tk, d, causal; stream
    "flash_attention": {
        f"flash_attention_{t}": (_PTR,) * 4 + (_I64,) * 5 + (_PTR,)
        for t in ("f32", "bf16")
    },
    # x, w, out; E, capacity, D, F, block_n, grid; stream
    "ragged_matmul_sm90": {
        "ragged_matmul_sm90_bf16": (_PTR,) * 3 + (_I64,) * 6 + (_PTR,),
    },
    # q, k, v, out; B*H, tq, tk, d, causal, block_q, block_k; stream
    "flash_attention_sm90": {
        "flash_attention_sm90_bf16": (_PTR,) * 4 + (_I64,) * 7 + (_PTR,),
    },
    # q, k_pages, v_pages, page_table, seq_lens, out, scratch;
    # B, H, d, P, page, n_max, pages per split; stream
    "paged_attention": {
        f"paged_attention_{t}": (_PTR,) * 7 + (_I64,) * 7 + (_PTR,)
        for t in ("f32", "bf16")
    },
    "rwkv6_scan": {
        # r, k, v, w, u, s0, y, s_out; B, T, H, hd; stream
        **{f"rwkv6_scan_fwd_{t}": (_PTR,) * 8 + (_I64,) * 4 + (_PTR,)
           for t in ("f32", "bf16")},
        # r, k, v, w, u, s0, dy, ds, ws, dr, dk, dv, dw, du, ds0;
        # B, T, H, hd; stream
        **{f"rwkv6_scan_bwd_{t}": (_PTR,) * 15 + (_I64,) * 4 + (_PTR,)
           for t in ("f32", "bf16")},
    },
    # r, k, v, w, u, s0, y, s_out; B, T, H, hd; stream
    "rwkv6_chunk_sm90": {
        f"rwkv6_scan_chunked_{t}": (_PTR,) * 8 + (_I64,) * 4 + (_PTR,)
        for t in ("f32", "bf16")
    },
    # r, k, v, w, u, s0, dy, ds, ws, dr, dk, dv, dw, du, ds0; B, T, H, hd;
    # stream
    "rwkv6_chunk_bwd_sm90": {
        f"rwkv6_scan_bwd_chunked_{t}": (_PTR,) * 15 + (_I64,) * 4 + (_PTR,)
        for t in ("f32", "bf16")
    },
    "mamba_scan": {
        # u, delta, B, C, a, s0, y, s_out; batch, T, D, N; stream
        **{f"mamba_scan_fwd_{t}": (_PTR,) * 8 + (_I64,) * 4 + (_PTR,)
           for t in ("f32", "bf16")},
        **{f"mamba_scan_chunk_{t}": (_PTR,) * 8 + (_I64,) * 4 + (_PTR,)
           for t in ("f32", "bf16")},
        # the same at T = 1: batch, D, N
        **{f"mamba_scan_decode_{t}": (_PTR,) * 8 + (_I64,) * 3 + (_PTR,)
           for t in ("f32", "bf16")},
        # the step pair and the chunk route's backward: u, delta, B, C, a,
        # s0, dy, ds, ws, du, sums (dB, dC, ddelta), da, ds0; batch, T, D,
        # N; stream
        **{f"mamba_scan_bwd_{route}{t}": (_PTR,) * 13 + (_I64,) * 4 + (_PTR,)
           for route in ("", "chunk_") for t in ("f32", "bf16")},
    },
    "chunked_attention_sm90": {
        # q, k, v, out, lse; B*H, tq, tk, d, causal, q_offset; stream
        "chunked_attention_tile_fwd_bf16": (_PTR,) * 5 + (_I64,) * 6 + (_PTR,),
        # q, k, v, out, lse, ws; B*H, tq, tk, d, causal, q_offset,
        # n_splits, split_keys; stream
        "chunked_attention_split_fwd_bf16": (_PTR,) * 6 + (_I64,) * 8 + (
            _PTR,),
    },
    "chunked_attention_bwd_sm90": {
        # q, k, v, out, dout, lse, stats, dq, dk, dv; B*H, tq, tk, d,
        # causal, q_offset; stream
        "chunked_attention_tile_bwd_bf16": (_PTR,) * 10 + (_I64,) * 6 + (
            _PTR,),
    },
    "chunked_attention_head": {
        # q, k, v, out, lse; B*H, tq, tk, d, causal, q_offset; stream
        **{f"chunked_attention_head_fwd_{t}": (_PTR,) * 5 + (_I64,) * 6 + (
            _PTR,) for t in ("f32", "bf16")},
        # q, k, v, out, dout, lse, dq, dk, dv; B*H, tq, tk, d, causal,
        # q_offset; stream
        **{f"chunked_attention_head_bwd_{t}": (_PTR,) * 9 + (_I64,) * 6 + (
            _PTR,) for t in ("f32", "bf16")},
    },
    "chunked_attention": {
        # q, k, v, out, lse; B*H, tq, tk, d, causal, q_offset; stream
        **{f"chunked_attention_fwd_{t}": (_PTR,) * 5 + (_I64,) * 6 + (_PTR,)
           for t in ("f32", "bf16")},
        # q, k, v, out, dout, lse, delta, dq, dk, dv; B*H, tq, tk, d,
        # causal, q_offset; stream
        **{f"chunked_attention_bwd_{t}": (_PTR,) * 10 + (_I64,) * 6 + (_PTR,)
           for t in ("f32", "bf16")},
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: compiler output (``-Xptxas -v``: registers, spills) of each build made
#: by this process
BUILD_LOG: Dict[str, str] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for this source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(SRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library is built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile every named source that is not built yet, all in parallel."""
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build((name,))
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS[name]


#: the TMA kernels return this plus the driver's CUresult when a TMA
#: tensor map cannot be encoded (``csrc/hopper.cuh``)
TENSOR_MAP_ERROR = 100000


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a launch error."""
    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"{what}: TMA tensor map encoding failed with "
                           f"CUresult {err - TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
