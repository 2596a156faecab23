"""The port stands alone: it imports without JAX, a CPU tensor never
launches a kernel (it runs the plain versions), a tensor on any other
non-CUDA device raises instead of falling back, each kernel family
refuses sizes outside its own domain, loading the CUDA library without
nvcc raises, and the constructors default to the card."""

import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import convert, models, stream
from chowdsp_fft_tpu_torch.ops import _cuda, hopper_cfft, hopper_composite, hopper_fft, hopper_small

REPO = pathlib.Path(__file__).resolve().parents[1]

_NO_JAX = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import torch
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import api, convert, models, plans, stream
from chowdsp_fft_tpu_torch.ops import (
    _cuda, convolve, hopper_cfft, hopper_composite, hopper_fft, hopper_small, layout, stockham, tables,
)
from chowdsp_fft_tpu_torch.stream import channelizer, demod, polyphase
from chowdsp_fft_tpu_torch.utils import native, profiling, roofline
from chowdsp_fft_tpu_torch.adapters import JuceStyleFFT, juce_like, numpy_like
x = torch.randn(2, 1024)
assert ct.make_plan(1024, "real").n == 1024 and ct.plan_bytes(1024, "real") > 0
with ct.merge_precision("bf16x3"):
    spec = numpy_like.rfft(x, device="cpu")
assert spec.shape == (2, 513)
assert JuceStyleFFT(10, device="cpu").perform_real_only_forward_transform(x).shape == (2, 1026)
re, im = ct.rfft_packed_unordered(x)
y = ct.irfft_packed_unordered(re, im)
assert torch.allclose(y / 1024, x, atol=2e-7 * 1024)
y = stream.fir_filter_ols(torch.randn(3000), torch.randn(33))
assert y.shape == (3000,)
for n in (256, 384, 16384):  # K5, K4 and composite sizes
    z = torch.randn(3, n, dtype=torch.complex64)
    assert torch.allclose(ct.ifft(ct.fft(z)) / n, z, atol=2e-7 * n)
x = torch.randn(2, 32768)  # the real composite
assert torch.allclose(ct.irfft_packed(*ct.rfft_packed(x)) / 32768, x, atol=2e-7 * 32768)
w = channelizer.channelize(torch.randn(16 * 64, dtype=torch.complex64), 16)
assert w.shape == (16, 64)
audio = models.SDRChain(models.SDRChainConfig(channels=16), device="cpu")(torch.randn(16 * 2 * 4 * 32, dtype=torch.complex64))
assert audio.shape == (16, 32) and bool(torch.isfinite(audio).all())
from chowdsp_fft_tpu_torch.models import convolver
from chowdsp_fft_tpu_torch.stream import stft
x = torch.randn(2, 4096)
assert torch.allclose(stream.istft(stream.stft(x, n_fft=512), length=4096), x, atol=1e-4)
conv = models.MultichannelConvolver(torch.randn(300) / 300, models.ConvolverConfig(channels=2, block=256), device="cpu")
assert conv.apply(x).shape == (2, 4096)
from chowdsp_fft_tpu_torch.ops import hopper_cfft as hc4
p = ct.cached_plan(1024, ct.FFT_REAL)
j = hopper_fft.rfft_packed_joint_db_kernel(x[:, :1024].contiguous(), p)
assert hopper_fft.irfft_packed_db_kernel(j[:, :512].contiguous(), j[:, 512:].contiguous(), p).shape == (2, 1024)
assert hc4.cfft_db_kernel(torch.randn(2, 1024, dtype=torch.complex64), ct.cached_plan(1024, ct.FFT_COMPLEX)).shape == (2, 1024)
assert all(k.launches == 0 for k in hopper_fft.KERNELS)
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
    stream.partitioned_fir_apply(xs, torch.ones(300) / 300, block=128)  # K5 real sizes
    stream.fir_filter_ols(xs[:1], torch.ones(5000) / 5000)  # N = 2^15: the real composite
    for n in (64, 480, 384, 1920, 16384, 576):  # K5, K4 and composite sizes
        z = torch.from_numpy((rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64))
        ct.ifft_unordered(ct.fft_unordered(z))
        ct.ifft_planes(*ct.fft_planes(z.real, z.imag, engine="hopper"), engine="hopper")
    plan, cplan = ct.cached_plan(2048, ct.FFT_REAL), ct.cached_plan(2048, ct.FFT_COMPLEX)
    j = hopper_fft.rfft_packed_joint_db_kernel(x, plan)  # the pipelined forms
    hopper_fft.irfft_packed_db_kernel(j[:, :1024].contiguous(), j[:, 1024:].contiguous(), plan)
    hopper_cfft.cfft_db_kernel(torch.complex(x, x), cplan)
    assert all(k.launches == 0 for k in hopper_fft.KERNELS)


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
    cplan = ct.cached_plan(1024, ct.FFT_COMPLEX)
    z = torch.empty(2, 1024, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hopper_cfft.cfft_kernel(z, cplan)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_cfft.cfft_kernel((x, x), cplan)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_fft.rfft_packed_joint_db_kernel(x, plan)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_fft.irfft_packed_db_kernel(s, s, plan)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_cfft.cfft_db_kernel(z, cplan)
    small = ct.cached_plan(256, ct.FFT_COMPLEX)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_small.small_cfft_kernel(z[:, :256], small)
    rplan = ct.cached_plan(256, ct.FFT_REAL)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_small.small_rfft_kernel(x[:, :256], rplan)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_small.small_irfft_kernel(s[:, :128], s[:, :128], rplan)
    z3 = torch.empty(2, 64, 32, dtype=torch.complex64, device="meta")
    for forward in (True, False):
        with pytest.raises(ValueError, match="CUDA"):
            hopper_composite.level1(z3, ct.cached_plan(64 if forward else 32, ct.FFT_COMPLEX), forward)
        with pytest.raises(ValueError, match="CUDA"):
            hopper_composite.level2(z3, torch.empty(64, 32, dtype=torch.complex64), ct.cached_plan(64, ct.FFT_COMPLEX),
                                    forward)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_composite.rfft_cols(torch.empty(2, 64, 32, device="meta"), ct.cached_plan(64, ct.FFT_REAL))
    p3 = torch.empty(2, 32, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hopper_composite.irfft_cols(p3, p3, ct.cached_plan(64, ct.FFT_REAL))
    assert all(k.launches == 0 for k in hopper_fft.KERNELS)


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


@pytest.mark.parametrize("kind,n,wrapper", [
    ("real", 256, "rfft_packed_kernel"),  # a K5 size: K1 must not run its four-step layout
    ("real", 256, "irfft_packed_kernel"),
    ("real", 256, "convolve_irfft_packed_kernel"),
    ("complex", 256, "cfft_kernel"),  # a K5 size
    ("complex", 16384, "cfft_kernel"),  # above MAX_CN: the composite's
    ("real", 384, "small_rfft_kernel"),  # a K1 size
    ("complex", 384, "small_cfft_kernel"),  # a K4 size
    ("complex", 4096, "level1"),  # columns longer than MAX_COL
    ("complex", 4096, "level2"),
    ("real", 4096, "rfft_cols"),
    ("real", 4096, "irfft_cols"),
    ("real", 1024, "level1"),  # a real plan on the complex column kernel
])
def test_each_kernel_family_checks_its_own_domain(kind, n, wrapper):
    """The engine serves the union of the kernel families; a kernel
    wrapper refuses sizes of another family's domain, on the CPU as on
    the card."""
    plan = ct.cached_plan(n, kind)
    assert hopper_fft.supports_plan(plan)
    m = n // 2
    args = {
        "rfft_packed_kernel": (hopper_fft.rfft_packed_kernel, (torch.zeros(2, n), plan)),
        "irfft_packed_kernel": (hopper_fft.irfft_packed_kernel, (torch.zeros(2, m), torch.zeros(2, m), plan)),
        "convolve_irfft_packed_kernel": (hopper_fft.convolve_irfft_packed_kernel,
                                         (*[torch.zeros(2, m)] * 4, 1.0, plan)),
        "cfft_kernel": (hopper_cfft.cfft_kernel, (torch.zeros(2, n, dtype=torch.complex64), plan)),
        "small_rfft_kernel": (hopper_small.small_rfft_kernel, (torch.zeros(2, n), plan)),
        "small_cfft_kernel": (hopper_small.small_cfft_kernel, (torch.zeros(2, n, dtype=torch.complex64), plan)),
        "level1": (hopper_composite.level1, (torch.zeros(2, n, 8, dtype=torch.complex64), plan)),
        "level2": (hopper_composite.level2, (torch.zeros(2, n, 8, dtype=torch.complex64),
                                             torch.zeros(n, 8, dtype=torch.complex64), plan)),
        "rfft_cols": (hopper_composite.rfft_cols, (torch.zeros(2, n, 8), plan)),
        "irfft_cols": (hopper_composite.irfft_cols, (torch.zeros(2, 8, m), torch.zeros(2, 8, m), plan)),
    }
    fn, a = args[wrapper]
    with pytest.raises(ValueError, match="outside the kernel domain"):
        fn(*a)


def test_constructors_default_to_the_card():
    """What builds state defaults to device="cuda" (on a machine without a
    card, asking for the default raises rather than quietly building on
    the CPU); functions that take tensors follow the tensor. Read off the
    signatures, so no tensor is built on a missing card."""
    builders = [
        models.SDRChain.__init__,
        models.MultichannelConvolver.__init__,
        stream.Channelizer.__init__,
        stream.design_lowpass,
        convert.partitioned_fir_from_numpy,
        convert.cfft_unordered_from_numpy,
        convert.sdr_chain_from_numpy,
        convert.convolver_from_numpy,
    ]
    for fn in builders:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    # A filter follows a tensor h, and goes to the card from anything else.
    assert inspect.signature(stream.PartitionedFIR.__init__).parameters["device"].default is None
    for fn in (stream.channelize, stream.fir_filter_ols, stream.stft, stream.istft, ct.fft, ct.rfft_packed):
        assert "device" not in inspect.signature(fn).parameters, fn.__qualname__


def test_filters_from_host_arrays_default_to_the_card():
    """PartitionedFIR and MultichannelConvolver built from a numpy array
    go to the card (here, without one, asking for it raises); a tensor
    keeps its device and ``device`` overrides both."""
    h = np.ones(300, np.float32) / 300
    cfg = models.ConvolverConfig(channels=2, block=128)
    assert stream.filter_device(h) == "cuda"
    assert stream.filter_device(torch.from_numpy(h)) == torch.device("cpu")
    assert stream.filter_device(h, "cpu") == "cpu"
    builds = (lambda: stream.PartitionedFIR(h, block=128), lambda: models.MultichannelConvolver(h, cfg))
    for build in builds:
        if torch.cuda.is_available():
            assert build().h_re.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                build()
    assert stream.PartitionedFIR(torch.from_numpy(h), block=128).h_re.device.type == "cpu"
    assert stream.PartitionedFIR(h, block=128, device="cpu").h_re.device.type == "cpu"
    assert models.MultichannelConvolver(h, cfg, device="cpu").h_re.device.type == "cpu"


def test_filter_takes_host_blocks_to_its_device():
    """A filter off the CPU takes numpy blocks to its own device in
    apply_offline, step and step_k, as JAX puts them on its device (a card
    filter used to refuse them). Shown on the "meta" device, where the
    Stockham engine runs shapes only."""
    fir = stream.PartitionedFIR(np.ones(300, np.float32), block=128, engine="stockham", device="meta")
    x = np.ones((2, 1000), np.float32)
    assert fir.apply_offline(x).device.type == "meta"
    state, y = fir.step(fir.init_state((2,)), x[:, :128])
    assert y.device.type == "meta"
    _, y = fir.step_k(state, x[:, :384].reshape(2, 3, 128))
    assert y.device.type == "meta" and y.shape == (2, 3, 128)


def _imported_modules(path: pathlib.Path) -> set[str]:
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted((REPO / "chowdsp_fft_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax(path):
    """No module of the port, and not chip_smoke.py, imports JAX or the JAX
    package, at any depth of the file (also inside functions)."""
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "chowdsp_fft_tpu"), (path.name, name)


def test_chip_smoke_refuses_a_machine_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where
    torch.cuda.is_available() is false, and from a directory that holds it
    alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
