"""The port stands alone: it imports without JAX, a CPU tensor never
launches a kernel (it runs the plain twins), a tensor on any other
non-CUDA device raises instead of falling back, and loading the CUDA
library without nvcc raises."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import stream
from chowdsp_fft_tpu_torch.ops import _cuda, hopper_fft

REPO = pathlib.Path(__file__).resolve().parents[1]

_NO_JAX = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import torch
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import api, convert, plans, stream
from chowdsp_fft_tpu_torch.ops import _cuda, convolve, hopper_fft, layout, stockham, tables
x = torch.randn(2, 1024)
re, im = ct.rfft_packed_unordered(x)
y = ct.irfft_packed_unordered(re, im)
assert torch.allclose(y / 1024, x, atol=2e-7 * 1024)
y = stream.fir_filter_ols(torch.randn(3000), torch.randn(33))
assert y.shape == (3000,)
assert not any(name == "jax" or name.startswith("jax.") for name, m in sys.modules.items() if m is not None)
assert not any(name.startswith("chowdsp_fft_tpu.") or name == "chowdsp_fft_tpu" for name in sys.modules)
print("ok")
"""


def test_imports_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cpu_tensors_launch_no_kernel():
    hopper_fft.reset_launch_counts()
    rng = np.random.default_rng(3)
    n = 2048
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    assert ct.engine_for(n, "real") == "hopper"
    for ordered in (True, False):
        fwd = ct.rfft_packed if ordered else ct.rfft_packed_unordered
        re, im = fwd(x)
        ct.convolve_irfft_packed(re, im, re[:1], im[:1], scaling=0.5, ordered=ordered)
    ct.irfft_packed(*ct.rfft_packed(x))
    ct.irfft(ct.rfft(x))
    xs = torch.from_numpy(rng.standard_normal((2, 5000)).astype(np.float32))
    stream.fir_filter_ols(xs, torch.ones(100) / 100)
    stream.partitioned_fir_apply(xs, torch.ones(1500) / 1500, block=1024, streaming=True, chunk=2)
    assert [k.launches for k in hopper_fft.KERNELS] == [0, 0, 0]


def test_non_cuda_device_raises_instead_of_falling_back():
    plan = ct.cached_plan(1024, ct.FFT_REAL)
    x = torch.empty(2, 1024, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hopper_fft.rfft_packed_kernel(x, plan)
    s = torch.empty(2, 512, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hopper_fft.irfft_packed_kernel(s, s, plan)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_fft.convolve_irfft_packed_kernel(s, s, s, s, 1.0, plan)
    assert [k.launches for k in hopper_fft.KERNELS] == [0, 0, 0]


def test_wrapper_input_checks():
    """What a kernel wrapper refuses before any launch."""
    t = torch.zeros(2, 8)
    hopper_fft._check("t", t, (2, 8), t.device)
    with pytest.raises(TypeError):
        hopper_fft._check("t", t.double(), (2, 8), t.device)
    with pytest.raises(ValueError, match="shape"):
        hopper_fft._check("t", t, (2, 4), t.device)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_fft._check("t", torch.zeros(8, 2).t(), (2, 8), t.device)
    with pytest.raises(RuntimeError, match="autograd"):
        hopper_fft._check("t", t.clone().requires_grad_(), (2, 8), t.device)


def test_loading_cuda_library_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    _cuda.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _cuda.library()
        with pytest.raises(RuntimeError, match="nvcc"):
            _cuda.build()
    finally:
        _cuda.library.cache_clear()
