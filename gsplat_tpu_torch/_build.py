"""Build the port's CUDA sources and load them through ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled by `nvcc` for Hopper (`sm_90a`) at first use into
`build/gsplat_tpu_torch/` at the repository root.  All sources build in
parallel, one `nvcc` each.  Shared device code lives in `csrc/*.cuh`.  A
library's file name carries a hash of its source, of every `csrc` header it
includes (directly or through another header) and of its flags, so an
edited source or header never loads a stale build.

Every C entry returns `cudaGetLastError()` after its launch; `check`
turns a non-zero code into an exception.  Nothing here falls back: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gsplat_tpu_torch"

COMMON_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills: ptxas_report
]
# Per-source flags.  expand.cu must round every f32 operation on its own
# (no fused multiply-add) so that its floor/ceil give the same integers as
# the plain PyTorch version, which rounds each elementwise op separately.
# Division and sqrt stay IEEE in both (no --use_fast_math anywhere).
SOURCE_FLAGS: Dict[str, List[str]] = {
    "expand": ["-fmad=false", "-prec-div=true", "-prec-sqrt=true"],
    # rasterize_fwd and rasterize_bwd share csrc/composite.cuh and must be
    # compiled alike: the backward replays the forward's gate and stop
    # decisions, which one rounding would flip.
    "rasterize_fwd": [],
    "rasterize_bwd": [],
    "segsum": [],
    "align": [],
    # rasterize2d_fwd and rasterize2d_bwd share csrc/surfel.cuh, as the 3DGS
    # pair shares composite.cuh: compiled alike
    "rasterize2d_fwd": [],
    "rasterize2d_bwd": [],
    # rasterize_eval3d_fwd and rasterize_eval3d_bwd share csrc/ray3d.cuh:
    # compiled alike, for the same reason
    "rasterize_eval3d_fwd": [],
    "rasterize_eval3d_bwd": [],
}
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU machine")


def _sources_of(name: str) -> List[Path]:
    """`csrc/<name>.cu` and the csrc headers it includes, transitively."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(COMMON_FLAGS + SOURCE_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _report_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".ptxas")


def ptxas_report(name: str) -> str:
    """nvcc's `-Xptxas -v` report for the current build of `csrc/<name>.cu`
    (registers, shared memory and spills of each kernel), kept beside the
    library so that a cached build still has it; "" if it was never built."""
    path = _report_path(name)
    return path.read_text() if path.exists() else ""


def build_all() -> Dict[str, float]:
    """Compile every source that has no current build; returns seconds each.

    The compilers run in parallel.  Raises with nvcc's output if any fails.
    """
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [n for n in SOURCE_FLAGS if not _lib_path(n).exists()]
        if not todo:
            return {}
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *COMMON_FLAGS, *SOURCE_FLAGS[name], "-o", tmp,
                   str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        seconds, errors = {}, []
        for name, (tmp, p) in procs.items():
            out, _ = p.communicate()
            seconds[name] = time.perf_counter() - t0
            if p.returncode != 0:
                os.unlink(tmp)
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
            else:
                _report_path(name).write_text(out)
                os.replace(tmp, _lib_path(name))
        if errors:
            raise RuntimeError("\n".join(errors))
        return seconds


_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_FLOAT = ctypes.c_float

# C signatures of every entry, by library.
_SIGNATURES = {
    "expand": {
        "gs_expand_rows": [_VOID, _VOID, _LL, _VOID, _LL, _FLOAT, _INT, _VOID, _VOID],
        "gs_expand_emission": [_VOID, _LL, _VOID, _LL, _INT, _VOID, _LL, _INT,
                               _INT, _INT, _INT, _INT, _VOID, _LL, _VOID, _VOID, _VOID],
        "gs_expand_aabb": [_VOID, _VOID, _LL, _VOID, _VOID, _INT, _VOID, _LL, _INT, _INT,
                           _INT, _VOID, _LL, _VOID, _VOID, _VOID, _VOID, _VOID],
    },
    "rasterize_fwd": {
        "gs_rasterize_fwd": [_VOID, _LL, _VOID, _INT, _INT, _INT, _INT, _INT,
                             _INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID],
    },
    "rasterize_bwd": {
        "gs_rasterize_bwd": [_VOID, _LL, _VOID, _INT, _INT, _INT, _INT, _INT,
                             _INT, _INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID,
                             _VOID, _VOID, _VOID],
    },
    "segsum": {
        "gs_segment_rowsum": [_VOID, _LL, _INT, _VOID, _LL, _VOID, _VOID],
    },
    "align": {
        "gs_align_rows": [_VOID, _LL, _VOID, _LL, _INT, _VOID, _VOID],
        "gs_gather_records": [_VOID, _INT, _INT, _VOID, _VOID, _VOID, _LL, _VOID, _VOID],
    },
    "rasterize2d_fwd": {
        "gs_rasterize2d_fwd": [_VOID, _LL, _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
                               _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID],
    },
    "rasterize2d_bwd": {
        "gs_rasterize2d_bwd": [_VOID, _LL, _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
                               _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID, _VOID],
    },
    "rasterize_eval3d_fwd": {
        "gs_rasterize_eval3d_fwd": [_VOID, _LL, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT,
                                    _INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID, _VOID,
                                    _VOID, _VOID, _VOID],
    },
    "rasterize_eval3d_bwd": {
        "gs_rasterize_eval3d_bwd": [_VOID, _LL, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT,
                                    _INT, _INT, _INT, _VOID, _VOID, _VOID, _VOID, _VOID,
                                    _VOID, _VOID, _VOID],
    },
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building every source first."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.gs_error_string.argtypes = [ctypes.c_int]
            lib.gs_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = lib.gs_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
