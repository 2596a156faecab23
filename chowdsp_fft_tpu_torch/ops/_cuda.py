"""Build and load the Hopper kernels (``csrc/*.cu``) on first use.

``nvcc`` compiles the sources into a shared library with a plain C
interface under ``build/hopper/`` beside the package (a directory
``.gitignore`` lists); the library is loaded with ``ctypes``. The file
name carries a hash of the sources, so an edited source is rebuilt and a
stale library is never loaded. Nothing here degrades: without ``nvcc`` or
without a CUDA device, :func:`library` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "hopper"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (pointers and the stream are
# c_void_p, so ctypes never truncates them to 32 bits).
_SIGNATURES = {
    "hopper_real_fft_max_n": [],
    "k1_rfft_packed": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P],
    "k2_irfft_packed": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P],
    "k3_convolve_irfft_packed": [
        _P, _P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _P, _I, _P, _P, _P, _P,
    ],
}


def find_nvcc() -> str:
    """Path of ``nvcc``; raises RuntimeError when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = pathlib.Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "the Hopper kernels need nvcc (CUDA toolkit) to build; none found on PATH or CUDA_HOME"
        )
    return nvcc


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels for sm_90a if they are not built yet; returns
    the library's path. Concurrent builders each write a private file and
    rename it into place."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libhopper_fft_{_source_hash()}.so"
    if lib.exists():
        return lib
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Raises
    RuntimeError if nvcc or a CUDA device is missing."""
    find_nvcc()
    if not torch.cuda.is_available():
        raise RuntimeError("the Hopper kernels need a CUDA device; torch.cuda.is_available() is False")
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
