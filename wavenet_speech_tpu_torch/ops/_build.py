"""Builds the hand-written CUDA kernels of ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) at its first CUDA
call and loaded with ``ctypes``. Libraries are cached in ``csrc/build/``
under a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is not. Nothing here runs at import: the package imports on a
machine with no GPU and no ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on any non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("fused_block", "fused_block_bwd", "ctc", "ctc_beam")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library in ``names`` that is not cached yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 when cached)."""
    nvcc = None
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        path = lib_path(name)
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, path) in jobs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``argtypes`` set from ``signatures`` and ``restype`` int for each entry
    point."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.wst_error_string.argtypes = [ctypes.c_int]
        lib.wst_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.wst_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
