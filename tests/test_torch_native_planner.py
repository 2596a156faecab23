"""The port's native planner binding (``utils/native.py``):
``tests/test_native_planner.py`` case for case, its tables bit-equal to the
JAX package's binding of the same source, the numpy fallback without g++,
and a build that never writes under ``native/`` and is safe when many
processes build at once."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu import plans as jax_plans
from chowdsp_fft_tpu.utils import native as jax_native
from chowdsp_fft_tpu_torch import plans
from chowdsp_fft_tpu_torch.utils import native
from torch_parity import np_, tol

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    lb = native.get_lib()
    if lb is None:
        pytest.skip("g++ unavailable: the plans use numpy (test_numpy_fallback_without_gxx)")
    return lb


# -- tests/test_native_planner.py, case for case ----------------------------


def test_native_factorize(lib):
    assert native.factorize(4096) == (4,) * 6
    assert native.factorize(480) == plans.factorize(480)
    assert native.factorize(7) is None


@pytest.mark.parametrize("n", [32, 96, 1024, 4096, 1 << 20])
def test_native_stage_twiddles_match_numpy(n, lib):
    tables = native.stage_twiddles(n)
    radices = plans.factorize(n)
    assert len(tables) == len(radices)
    sub = n
    for (re, im), r in zip(tables, radices):
        m = sub // r
        j = np.arange(r)[:, None]
        p = np.arange(m)[None, :]
        ang = -2 * np.pi * (j * p % sub) / sub
        np.testing.assert_allclose(re, np.cos(ang), atol=1e-14)
        np.testing.assert_allclose(im, np.sin(ang), atol=1e-14)
        sub = m


def test_native_rfft_twiddles(lib):
    n = 8192
    re, im = native.rfft_twiddles(n)
    k = np.arange(n // 2)
    np.testing.assert_allclose(re, np.cos(-2 * np.pi * k / n), atol=1e-14)
    np.testing.assert_allclose(im, np.sin(-2 * np.pi * k / n), atol=1e-14)


def test_native_dft_matrix_unitary(lib):
    l = 128  # noqa: E741
    re, im = native.dft_matrix(l)
    M = re + 1j * im
    np.testing.assert_allclose(M @ M.conj().T / l, np.eye(l), atol=1e-12)


def test_native_fourstep(lib):
    n, lanes = 4096, 128
    re, im = native.fourstep_twiddles(n, lanes)
    k1 = np.arange(n // lanes)[:, None]
    n2 = np.arange(lanes)[None, :]
    ang = -2 * np.pi * (k1 * n2 % n) / n
    np.testing.assert_allclose(re, np.cos(ang), atol=1e-14)
    np.testing.assert_allclose(im, np.sin(ang), atol=1e-14)


def test_plans_use_native_when_available(lib):
    """A plan built while the planner is available holds its tables, cast
    to float32, and drives a correct transform."""
    n = 1024
    plan = ct.make_plan(n, ct.FFT_REAL)
    for st, (re, im) in zip(plan.stages, native.stage_twiddles(n // 2)):
        np.testing.assert_array_equal(st.tw_re, re.astype(np.float32))
        np.testing.assert_array_equal(st.tw_im, im.astype(np.float32))
    x = np.random.default_rng(0).standard_normal((2, n)).astype(np.float32)
    got = np_(ct.rfft(torch.from_numpy(x), plan=plan, engine="stockham"))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ref, atol=tol(n), rtol=0)


def test_roofline_sanity():
    from chowdsp_fft_tpu_torch.utils.roofline import conv_roofline, fft_roofline

    r = fft_roofline(4096, 1024, "real")
    assert r.bound_by in ("bytes", "operations")
    samples_per_s = 4096 * 1024 / r.seconds
    assert 1e11 < samples_per_s < 1e12  # H100: 3.35 TB/s over 8 bytes a sample in and out
    assert r.seconds_memory > 0 and r.seconds_compute > 0
    assert conv_roofline(8192, 128).seconds > 0


# -- against the JAX package's binding --------------------------------------


@pytest.mark.parametrize("n", [96, 4096, 1 << 20])
def test_native_tables_bit_equal_to_jax_binding(n, lib):
    """One source, two bindings: the same float64 tables, bit for bit."""
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's planner did not load in this process")
    assert native.factorize(n) == jax_native.factorize(n)
    for (a, b), (c, d) in zip(native.stage_twiddles(n), jax_native.stage_twiddles(n)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for a, b in zip(native.rfft_twiddles(n), jax_native.rfft_twiddles(n)):
        np.testing.assert_array_equal(a, b)


# -- without g++, and where the build writes --------------------------------


def test_numpy_fallback_without_gxx(monkeypatch, tmp_path):
    """No g++ on PATH and no library built: the planner is unavailable and
    the plans take numpy's float64 tables, bit-equal to the JAX package's
    numpy construction."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.ensure_built() is None
    assert not native.available()
    assert native.stage_twiddles(1024) is None and native.factorize(1024) is None
    n = 1536
    plan = ct.make_plan(n, ct.FFT_REAL)
    sub = n // 2
    for st in plan.stages:
        want_re, want_im = jax_plans._stage_twiddle_np(sub, st.radix)
        np.testing.assert_array_equal(st.tw_re, want_re)
        np.testing.assert_array_equal(st.tw_im, want_im)
        sub //= st.radix
    k = np.arange(n // 2, dtype=np.float64)
    np.testing.assert_array_equal(plan.rfft_tw_re, np.cos(-2.0 * np.pi * k / n).astype(np.float32))
    np.testing.assert_array_equal(plan.rfft_tw_im, np.sin(-2.0 * np.pi * k / n).astype(np.float32))
    x = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    got = np_(ct.rfft(torch.from_numpy(x), plan=plan))
    assert np.abs(got - np.fft.rfft(x.astype(np.float64), axis=-1)).max() < tol(n)
    assert not list((tmp_path / "build").glob("*"))


def _copy_of_port(dest: pathlib.Path) -> pathlib.Path:
    """The port and the planner's source alone, in ``dest``."""
    shutil.copytree(REPO / "chowdsp_fft_tpu_torch", dest / "chowdsp_fft_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "native").mkdir()
    shutil.copy2(REPO / "native" / "planner.cpp", dest / "native" / "planner.cpp")
    return dest


def _listing(d: pathlib.Path) -> dict[str, int]:
    return {str(p.relative_to(d)): p.stat().st_mtime_ns for p in sorted(d.rglob("*"))}


def _run(code: str, cwd: pathlib.Path, n: int = 1) -> list[subprocess.CompletedProcess]:
    """``n`` interpreters on ``code`` at once, each importing from ``cwd``."""
    env = dict(os.environ, PYTHONPATH=str(cwd))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(n)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        out.append(subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr))
    return out


_BUILD_AND_PLAN = """
import numpy as np
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.utils import native
plan = ct.make_plan(4096, "real")
if native.available():
    assert native.library_path().parent.name == "native" and native.library_path().parent.parent.name == "build"
    np.testing.assert_array_equal(plan.rfft_tw_re, native.rfft_twiddles(4096)[0].astype(np.float32))
print("ok", native.available())
"""


def test_port_never_writes_under_native(tmp_path):
    """The port builds its planner under build/native/ and leaves native/
    (where the JAX package builds its own library) as it found it: same
    listing, same mtimes. Run on a copy of the port, so no other process
    touches the directories watched."""
    root = _copy_of_port(tmp_path)
    before = _listing(root / "native")
    (res,) = _run(_BUILD_AND_PLAN, root)
    assert res.returncode == 0, res.stderr
    assert _listing(root / "native") == before
    built = list((root / "build" / "native").glob("libchowplan_*.so"))
    if shutil.which("g++"):
        assert res.stdout.split() == ["ok", "True"] and len(built) == 1
    else:
        assert res.stdout.split() == ["ok", "False"] and not built


def test_concurrent_builds_are_race_free(tmp_path):
    """Eight processes force a build of the same library at once: each
    compiles into its own temporary file and renames it into place, so
    every one loads a whole library and no temporary file is left."""
    if not shutil.which("g++"):
        pytest.skip("g++ unavailable")
    root = _copy_of_port(tmp_path)
    code = """
from chowdsp_fft_tpu_torch.utils import native
assert native.ensure_built(force=True) is not None
assert native.factorize(4096) == (4,) * 6, native.factorize(4096)
print("ok")
"""
    for res in _run(code, root, n=8):
        assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    # The copy's source and flags are this checkout's: the same name.
    assert [p.name for p in (root / "build" / "native").iterdir()] == [native.library_path().name]
