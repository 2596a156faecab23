"""ctypes bindings over the repo's native C++ planner (``native/planner.cpp``).

PyTorch port's counterpart of ``chowdsp_fft_tpu/utils/native.py``: the
same source, the same functions and the same float64 results, so the
port's plans hold the same tables as the JAX package's, bit for bit. The
planner evaluates each twiddle in long double with exact argument
reduction, which rounds even N = 2^20 tables correctly to float64.

The library is built with ``g++`` into ``build/native/`` beside the
package (a directory ``.gitignore`` lists), under a name that carries a
hash of the source and the flags. Each builder compiles into a private
temporary file and renames it into place, so concurrent processes (test
workers) never load a half-written library. It never writes under
``native/``, where the JAX package builds its own copy. Without ``g++``,
:func:`available` is false and the plans build their tables with numpy.
This is host code: no device is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "planner.cpp"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64 = ctypes.c_int, ctypes.c_int64
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.chow_factorize.restype = i32
    lib.chow_factorize.argtypes = [i32, iptr, i32]
    lib.chow_stage_table_size.restype = i64
    lib.chow_stage_table_size.argtypes = [i32]
    lib.chow_fill_stage_twiddles.restype = i32
    lib.chow_fill_stage_twiddles.argtypes = [i32, dptr]
    lib.chow_fill_rfft_twiddles.restype = i32
    lib.chow_fill_rfft_twiddles.argtypes = [i32, dptr]
    lib.chow_fill_fourstep_twiddles.restype = i32
    lib.chow_fill_fourstep_twiddles.argtypes = [i32, i32, dptr]
    lib.chow_fill_dft_matrix.restype = i32
    lib.chow_fill_dft_matrix.argtypes = [i32, dptr]
    return lib


def library_path() -> pathlib.Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libchowplan_{h.hexdigest()[:16]}.so"


def ensure_built(force: bool = False) -> pathlib.Path | None:
    """Build the planner with g++ if it is not built yet. Returns the
    library's path, or None where g++ or the source is missing or the
    compile fails."""
    cxx = shutil.which("g++")
    if cxx is None or not SRC.exists():
        return None
    lib = library_path()
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = pathlib.Path(tmp) / lib.name
        try:
            subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(out)],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(out, lib)
    return lib


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native planner; None if unavailable.
    The outcome is kept for the process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = ensure_built()
        if path is None:
            return None
        try:
            _lib = _configure(ctypes.CDLL(str(path)))
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# numpy in and out, float64
# ---------------------------------------------------------------------------


def factorize(n: int) -> tuple[int, ...] | None:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.zeros(64, np.int32)
    cnt = lib.chow_factorize(n, buf, 64)
    if cnt < 0:
        return None
    return tuple(int(r) for r in buf[:cnt])


def stage_twiddles(n: int) -> list[tuple[np.ndarray, np.ndarray]] | None:
    """Per-stage (re, im) float64 tables of the Stockham plan of length n,
    each shaped (r, m)."""
    lib = get_lib()
    if lib is None:
        return None
    total = lib.chow_stage_table_size(n)
    if total < 0:
        return None
    buf = np.zeros(int(total), np.float64)
    if lib.chow_fill_stage_twiddles(n, buf) < 0:
        return None
    out = []
    off, sub = 0, n
    for r in factorize(n):
        m = sub // r
        re = buf[off : off + r * m].reshape(r, m).copy()
        im = buf[off + r * m : off + 2 * r * m].reshape(r, m).copy()
        out.append((re, im))
        off += 2 * r * m
        sub = m
    return out


def rfft_twiddles(n: int) -> tuple[np.ndarray, np.ndarray] | None:
    """The real transform's split twiddles exp(-2i*pi*k/n), k in [0, n/2)."""
    lib = get_lib()
    if lib is None:
        return None
    m = n // 2
    buf = np.zeros(2 * m, np.float64)
    if lib.chow_fill_rfft_twiddles(n, buf) < 0:
        return None
    return buf[:m].copy(), buf[m:].copy()


def fourstep_twiddles(n: int, lanes: int) -> tuple[np.ndarray, np.ndarray] | None:
    """W_n^(k1*n2), shaped (n/lanes, lanes)."""
    lib = get_lib()
    if lib is None:
        return None
    n1 = n // lanes
    buf = np.zeros(2 * n1 * lanes, np.float64)
    if lib.chow_fill_fourstep_twiddles(n, lanes, buf) < 0:
        return None
    sz = n1 * lanes
    return buf[:sz].reshape(n1, lanes).copy(), buf[sz:].reshape(n1, lanes).copy()


def dft_matrix(l: int) -> tuple[np.ndarray, np.ndarray] | None:  # noqa: E741
    """The l-point DFT matrix exp(-2i*pi*j*k/l)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.zeros(2 * l * l, np.float64)
    if lib.chow_fill_dft_matrix(l, buf) < 0:
        return None
    return buf[: l * l].reshape(l, l).copy(), buf[l * l :].reshape(l, l).copy()
