"""Property fuzz of the port across the real size domain (port of
``tests/test_pallas_engine.py::test_fuzz_random_sizes_and_batches``):
random valid real sizes from 8 to 3000 and odd batches, drawn once from a
fixed seed, through ``ct.rfft_packed``/``irfft_packed`` (engine ``auto``)
against float64 and the JAX package's ``cf.rfft_packed``/``irfft_packed``,
then through the numpy adapter's ``rfft``/``irfft`` against the JAX
adapter's. It catches regime-boundary slips the parametrized tests miss."""

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu.adapters import numpy_like as jnl
from chowdsp_fft_tpu_torch.adapters import numpy_like as nl
from torch_parity import max_abs, np_, packed_ref, tol


def _draws(count: int = 10, seed: int = 0xF022) -> list[tuple[int, int]]:
    rng = np.random.default_rng(seed)
    valid = [n for n in range(8, 3000) if ct.is_valid_size(n, ct.FFT_REAL)]
    picks = rng.choice(len(valid), size=count, replace=False)
    return [(valid[i], 2 * int(rng.integers(0, 4)) + 1) for i in picks]  # batches 1, 3, 5, 7


@pytest.mark.parametrize("n,b", _draws())
def test_fuzz_random_sizes_and_batches(n, b):
    rng = np.random.default_rng(n * 8 + b)
    x = rng.standard_normal((b, n)).astype(np.float32)
    re, im = ct.rfft_packed(torch.from_numpy(x))
    want_re, want_im = packed_ref(x)
    assert max_abs(re, want_re) < tol(n), n
    assert max_abs(im, want_im) < tol(n), n
    jre, jim = cf.rfft_packed(x)
    assert max_abs(re, jre) < tol(n) and max_abs(im, jim) < tol(n), n
    back = ct.irfft_packed(re, im)
    assert max_abs(np_(back) / n, x) < tol(n), n
    assert max_abs(np_(back) / n, np.asarray(cf.irfft_packed(jre, jim)) / n) < tol(n), n

    spec = nl.rfft(x, device="cpu")
    assert max_abs(spec, jnl.rfft(x)) < tol(n), n
    s64 = np.fft.rfft(x.astype(np.float64), axis=-1).astype(np.complex64)
    assert max_abs(nl.irfft(s64, n=n, device="cpu"), jnl.irfft(s64, n=n)) < tol(n), n
    assert max_abs(nl.irfft(np_(spec), n=n, device="cpu"), x) < tol(n), n
