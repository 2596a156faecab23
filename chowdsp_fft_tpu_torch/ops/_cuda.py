"""Build, load and launch the Hopper kernels (``csrc/*.cu``).

``nvcc`` compiles each source into an object, all sources at once in
parallel, and links them into one shared library with a plain C interface
under ``build/hopper/`` beside the package (a directory ``.gitignore``
lists); the library is loaded with ``ctypes``. The file name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing here degrades: without ``nvcc`` or
without a CUDA device, :func:`library` raises.

The kernels' size limits are defined here once and passed to ``nvcc`` as
macros; each source static-asserts that its limit fits shared memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from ..utils.tracing import LAUNCH_SPAN, span

# Largest real N of K1-K3: two padded N/2-point buffers, 8.25N bytes.
MAX_N = 16384
# Largest complex N of K4: two padded N-point buffers, 16.5N bytes, within
# the 227 KB a block may use (n1 = 108; 16384 would need 270 KB).
MAX_CN = 13824
# Largest N of K5, the small-N FFT: the JAX package's small-N domain ends
# below 512.
MAX_SMALL_N = 511
# Longest column of the composite's column kernels (K6, K7): they hold
# tiles of at most 8192 points (ops/col_passes: two padded buffers of a
# wide tile take 135 KB), so a column of 2048 complex points takes a tile
# of 4 or 2 columns. Every composite split up to 2^20 has a balanced pair
# within it (the largest needed factor is 1080).
MAX_COL = 2048
# Longest filter and largest factor of the polyphase decimator
# (csrc/polyphase.cu): its staged span and reversed taps stay within 48 KB
# of shared memory at every factor up to the largest.
MAX_DECIM_TAPS = 1024
MAX_DECIM_FACTOR = 16

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "hopper"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    f"-DCHOWDSP_MAX_N={MAX_N}", f"-DCHOWDSP_MAX_CN={MAX_CN}", f"-DCHOWDSP_MAX_SMALL_N={MAX_SMALL_N}",
    f"-DCHOWDSP_MAX_COL={MAX_COL}", f"-DCHOWDSP_MAX_DECIM_TAPS={MAX_DECIM_TAPS}",
    f"-DCHOWDSP_MAX_DECIM_FACTOR={MAX_DECIM_FACTOR}",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (pointers and the stream are
# c_void_p, so ctypes never truncates them to 32 bits).
_SIGNATURES = {
    "hopper_real_fft_max_n": [],
    "hopper_complex_fft_max_n": [],
    "hopper_small_fft_max_n": [],
    "hopper_small_fft_points_per_thread": [],
    "hopper_small_fft_blocks_per_sm": [_I, _I, _I],
    "hopper_row_points_per_thread": [],
    # Blocks resident per SM at (threads, shared bytes): K1, K2 or K3
    # (which = 1, 2, 3), and K4.
    "hopper_real_fft_blocks_per_sm": [_I, _I, _I],
    "hopper_complex_fft_blocks_per_sm": [_I, _I],
    # K1: x, y re/im, output row stride, rows, N, radices, nstages, pass
    # plan (r0, r1 pairs), npasses, pass twiddles, split twiddles (in
    # position order),
    # permutation, launch geometry (rows per block, threads, shared bytes,
    # grid), stream.
    "k1_rfft_packed": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # K2: y re/im, x, rows, N, then K1's arguments from the radices on
    # (the split twiddles in bin order); K3: A re/im, B re/im, B rows,
    # scale, then K2's.
    "k2_irfft_packed": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "k3_convolve_irfft_packed": [
        _P, _P, _P, _P, _I, ctypes.c_float, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P,
    ],
    # K4: x re/im, y re/im, element stride, rows, N, sign, radices,
    # nstages, pass plan, npasses, pass twiddles, permutation, geometry,
    # stream.
    "k4_cfft": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    # K5: K4's arguments without the permutation, then the launch geometry
    # (tile shift, threads, shared bytes, grid), stream.
    "k5_small_cfft": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P],
    # K5 real: x or packed re/im, output(s), rows, N, radices, nstages,
    # stage twiddles, split twiddles, geometry, stream.
    "k5_small_rfft": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "k5_small_irfft": [_P, _P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "hopper_composite_max_col": [],
    # Column-engine blocks resident per SM: role (K6 l1, l2, l2_rev,
    # l1_rev, K7b, K7a, then l2 and l2_rev on packed planes), shape
    # (narrow, wide, in place), threads, shared bytes.
    "hopper_composite_blocks_per_sm": [_I, _I, _I, _I],
    # K6 roles: x re/im, y re/im, element stride, batch, L, M, radices,
    # nstages, pass plan, npasses, pass twiddles, four-step twiddles (NULL
    # at level 1), launch geometry (lanes' shift, threads, shared bytes,
    # grid), stream.
    **{name: [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P]
       for name in ("k6_l1", "k6_l2", "k6_l2_rev", "k6_l1_rev")},
    # K6 level 2 of the real composite on its ordered packed planes: the
    # same, with the DC and Nyquist lines' pointer in the stride's place.
    **{name: [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P]
       for name in ("k6_l2_packed", "k6_l2_rev_packed")},
    # K7a: real in, packed re/im out; K7b: packed re/im in, real out; then
    # batch, A, C, radices, nstages, pass plan, npasses, pass twiddles,
    # split twiddles, launch geometry, stream.
    **{name: [_P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P]
       for name in ("k7a_rfft_cols", "k7b_irfft_cols")},
    # The pipelined forms take their grid kernel's arguments (K1-db and
    # K4-db without the launch geometry: they pick a persistent grid).
    "hopper_pipelined_blocks_per_sm": [_I, _I],
    "k1db_rfft_packed": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    "k2db_irfft_packed": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    "k4db_cfft": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P],
    # The offline FDL (ops/convolve): x re/im, h re/im, y re/im, streams,
    # blocks, slots, partitions, shared filter, sub-rings, run, scale,
    # stream.
    "partitioned_accumulate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # The packed product (ops/convolve): a, b, ab re/im (ab NULL: none), y
    # re/im, outer, inner, slots, frames a unit, width, scale, scale's
    # device pointer (NULL: the number), blocks, stream.
    "packed_product": [*[_P] * 8, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, ctypes.c_float, _P, _I, _P],
    # The polyphase decimator (ops/polyphase): x, h, y, rows, T, row and
    # sample strides, factor, taps, threads, rows a block, stream.
    "hopper_decimate_max_taps": [],
    "hopper_decimate_max_factor": [],
    "polyphase_decimate": [_P, _P, _P, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _I, _P],
    # The FM discriminator (ops/demod): z, y, batch, rows, T, z's batch,
    # row and sample strides (complex elements), y's (floats), gain,
    # layout, stream.
    "fm_demod": [_P, _P, _I, _I, _I, *[ctypes.c_longlong] * 6, ctypes.c_float, _I, _P],
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


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with every failure's stderr,
    else return each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors, outs = [], []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        outs.append(err)
        if proc.returncode != 0:
            errors.append(f"{' '.join(cmd)} -> {proc.returncode}\n{err}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return outs


def build() -> pathlib.Path:
    """Compile the kernels for sm_90a if they are not built yet; returns
    the library's path. One nvcc per source, all started together, then
    one link. Concurrent builders each work in a private directory and
    rename the library into place."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libhopper_fft_{_source_hash()}.so"
    if lib.exists():
        return lib
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in _sources()]
        reports = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(s)]
                            for s, o in zip(_sources(), objs)])
        out = pathlib.Path(tmp) / lib.name
        _run_all([[nvcc, "-shared", "-o", str(out), *map(str, objs)]])
        ptxas_report(lib).write_text("".join(reports))
        os.replace(out, lib)
    return lib


def ptxas_report(lib: pathlib.Path) -> pathlib.Path:
    """Where :func:`build` keeps ptxas's resource report (registers,
    spills, stack) of the library's kernels."""
    return lib.with_suffix(".ptxas.txt")


def kernel_resources(lib: pathlib.Path, name: str) -> list[str]:
    """ptxas's register and spill lines for each compiled kernel whose
    mangled name contains ``name``: "<mangled tail>: <lines>"."""
    out, cur = [], None
    for line in ptxas_report(lib).read_text().splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "'" in line else None
        elif "Function properties for" in line:
            cur = line.split("for")[-1].strip()
        elif cur and name in cur and ("registers" in line or "spill" in line):
            out.append(f"{cur[-48:]}: {line.split(':', 1)[-1].strip()}")
    return out


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


# ---------------------------------------------------------------------------
# What every kernel wrapper shares
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Kernel:
    """A kernel's identity and its launch count (incremented once per
    launch of the CUDA kernel, never by the plain version). ``span`` names
    the span around each launch."""

    name: str
    source: str
    replaces: str
    launches: int = 0
    span: str = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.span = LAUNCH_SPAN + self.name


def check(name: str, t: torch.Tensor, shape: tuple[int, ...], device: torch.device,
          dtype: torch.dtype = torch.float32, align: int = 8, contiguous: bool = True):
    """Refuse what a kernel does not take: another dtype, device or shape,
    a non-contiguous tensor (unless the kernel takes strides:
    ``contiguous=False``) or one not ``align``-byte aligned (16 for the
    pipelined kernels' 16-byte copies), a lazy conjugate or negative view
    (its memory holds the unconjugated values), or one that requires
    grad (the engine entries differentiate, ``ops/autodiff.py``)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected {align}-byte aligned data")
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{name}: expected materialized data, got a lazy conjugate or negative view "
                         "(resolve_conj() / resolve_neg())")
    if t.requires_grad:
        raise RuntimeError(
            f"{name}: a kernel wrapper takes no input that requires grad; for autograd, call the "
            "engine entries (ct.rfft_packed, ct.irfft_packed, ct.convolve_irfft_packed, ct.fft, "
            "ct.fft_planes, ...), which route through ops.autodiff's Functions, or detach the input"
        )


@functools.lru_cache(maxsize=512)
def host_ints(values: tuple[int, ...]):
    """``values`` as a C int array (cached, so it outlives the call that
    passes its address)."""
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=128)
def device_perm(perm_fn, n: int, device: str) -> torch.Tensor:
    """The int32 permutation ``perm_fn(n)`` (one of ``tables``' layouts or
    their inverses) as a tensor on ``device``."""
    return torch.from_numpy(perm_fn(n).copy()).to(device)


def takes_plain(name: str, *xs) -> bool:
    """The one rule that picks a kernel or its plain version, from where
    the tensors lie (each of ``xs`` a tensor or a tuple of tensors): True
    when every one is on the CPU (the plain version runs), False when
    every one is on one CUDA device (the kernel runs); anything else
    raises ValueError."""
    devices = _devices(xs)
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise _off_card(name, devices)


def require_cuda(name: str, *xs) -> None:
    """:func:`takes_plain`'s rule for a kernel entry with no plain route:
    every one of ``xs`` on one CUDA device, or the same ValueError."""
    if takes_plain(name, *xs):
        raise _off_card(name, _devices(xs))


def _devices(xs) -> set:
    return {t.device for x in xs for t in ((x,) if isinstance(x, torch.Tensor) else x)}


def _off_card(name: str, devices) -> ValueError:
    got = ", ".join(sorted(map(str, devices)))
    return ValueError(f"{name}: the Hopper kernels run on CUDA tensors, got {got}")


def require_domain(kernel: Kernel, ok: bool, n: int, kind: str):
    """Each kernel family checks its own size domain before it runs, on
    any device."""
    if not ok:
        raise ValueError(f"{kernel.name}: {kind} N={n} is outside the kernel domain")


def launch(kernel: Kernel, entry: str, device: torch.device, *args):
    """Call C entry ``entry`` with ``args`` and the current stream of
    ``device``; raise on a refused launch, else count it."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with span(kernel.span):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with cudaError {err}")
    kernel.launches += 1
