"""ctypes binding of the host C++ CTC prefix beam search (``ctc_beam.cc``;
wavenet_speech_tpu/native/ctc_beam.py).

The library is compiled by ``g++`` at its first use in a process, never at
import. It goes into ``native/build/`` (listed in ``.gitignore``) under a
hash of the source and the flags, so an edited source gets a library of
its own and a stale one is never loaded. The JAX package writes
``libctcbeam.so`` beside its source in every process, so two processes
that build at once can load a half-written file; here the build runs under
an exclusive lock on the build directory, ``g++`` writes a file of its own
process, and ``os.replace`` puts the whole file in place. A library that
does not load, or lacks its entry point, is rebuilt. No ``-march=native``:
the directory may travel to another machine with its checkout.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

SRC = Path(__file__).resolve().parent / "ctc_beam.cc"
BUILD_DIR = SRC.parent / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ENTRY = "ctc_beam_search_batch"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def lib_path(build_dir: Union[str, Path] = BUILD_DIR) -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return Path(build_dir) / f"libctcbeam-{h.hexdigest()[:16]}.so"


def _open(path: Path) -> ctypes.CDLL:
    """The library at path with its entry point typed; OSError or
    AttributeError when it is missing, not a library, or lacks the entry."""
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, ENTRY)
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_float),            # log_probs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, T, C
        ctypes.POINTER(ctypes.c_int32),            # lengths (nullable)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # beam, blank, max_len
        ctypes.POINTER(ctypes.c_int32),            # out_labels
        ctypes.POINTER(ctypes.c_int32),            # out_lengths
        ctypes.POINTER(ctypes.c_float),            # out_scores
        ctypes.POINTER(ctypes.c_int32),            # out_times (nullable)
        ctypes.c_int,                              # num_threads
    ]
    fn.restype = None
    return lib


@contextlib.contextmanager
def _dir_lock(build_dir: Path):
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)  # released when the file closes or the process dies
        yield


def _compile(path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ invocation failed: {e}") from e
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed: {proc.stderr[-2000:]}")
    os.replace(tmp, path)  # atomic: a loader sees no file or the whole file


def load_library(build_dir: Union[str, Path] = BUILD_DIR) -> ctypes.CDLL:
    """The library, built into build_dir first unless a loadable one is
    there. Concurrent callers, in threads or processes, build it once;
    RuntimeError when g++ fails."""
    path = lib_path(build_dir)
    try:
        return _open(path)
    except (OSError, AttributeError):
        pass
    with _dir_lock(Path(build_dir)):
        try:  # another process may have built it while this one waited
            return _open(path)
        except (OSError, AttributeError):
            _compile(path)
        return _open(path)


def _load() -> Optional[ctypes.CDLL]:
    """This process's library from BUILD_DIR, or None with the build error
    recorded (a failed build is not retried in the process, as in JAX)."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                _lib = load_library()
            except (RuntimeError, OSError, AttributeError) as e:
                _build_error = str(e)
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def ctc_beam_search_native(logits, beam_width: int = 7, blank: int = 0,
                           lengths=None, max_label_len: Optional[int] = None,
                           log_input: bool = False, num_threads: int = 0,
                           return_times: bool = False) -> Tuple[np.ndarray, ...]:
    """Batched CTC prefix beam search in the native library, each sequence
    on a host thread (num_threads 0: one a core, at most B).

    logits: (B, T, C) float array, log-softmaxed here unless log_input.
    lengths: (B,) valid frames (default T). max_label_len caps the decoded
    length (default T).
    Returns (labels (B, S) int32 0-padded, lengths (B,) int32, scores (B,)
    float32[, times (B, S) int32, each label's emission frame]), the best
    beam of each sequence. RuntimeError when the library cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ctc beam unavailable: {_build_error}")
    logits = np.ascontiguousarray(logits, dtype=np.float32)
    if logits.ndim != 3:
        raise ValueError(f"logits must be (B, T, C), got shape {logits.shape}")
    B, T, C = logits.shape
    if not (beam_width >= 1 and 0 <= blank < C):
        raise ValueError(f"bad beam_width={beam_width} or blank={blank} for C={C}")
    if not log_input:
        m = logits.max(axis=-1, keepdims=True)
        logits = logits - m
        logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        logits = np.ascontiguousarray(logits, dtype=np.float32)
    S = int(max_label_len) if max_label_len is not None else T
    if S < 1:
        raise ValueError(f"max_label_len must be >= 1, got {S}")
    out_labels = np.zeros((B, S), np.int32)
    out_lengths = np.zeros((B,), np.int32)
    out_scores = np.zeros((B,), np.float32)
    out_times = np.zeros((B, S), np.int32)
    len_ptr = None
    if lengths is not None:
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        if lengths.shape != (B,):
            raise ValueError(f"lengths must be ({B},), got {lengths.shape}")
        len_ptr = _ptr(lengths, ctypes.c_int32)
    getattr(lib, ENTRY)(
        _ptr(logits, ctypes.c_float), B, T, C, len_ptr, int(beam_width), int(blank), S,
        _ptr(out_labels, ctypes.c_int32), _ptr(out_lengths, ctypes.c_int32),
        _ptr(out_scores, ctypes.c_float), _ptr(out_times, ctypes.c_int32), int(num_threads))
    if return_times:
        return out_labels, out_lengths, out_scores, out_times
    return out_labels, out_lengths, out_scores
