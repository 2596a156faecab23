"""Helpers shared by the port's parity tests: the same seeded numpy inputs
go through the JAX package and the port, and the results meet in numpy."""

import numpy as np
import torch

TOL = 2e-7  # times N: the JAX package's bound against float64


def tol(n: int) -> float:
    return TOL * n


def np_(t) -> np.ndarray:
    """A tensor (any device) or a JAX/numpy array as a numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def max_abs(got, want) -> float:
    """Max abs difference, in float64 (complex128)."""
    a, b = np_(got), np_(want)
    wide = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) else np.float64
    return float(np.abs(a.astype(wide) - b.astype(wide)).max())


def crandn(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def packed_ref(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 packed planes of real rows: re[0] = DC, im[0] = Nyquist."""
    n = x.shape[-1]
    spec = np.fft.rfft(x.astype(np.float64), axis=-1)
    re = spec[..., : n // 2].real.copy()
    im = spec[..., : n // 2].imag.copy()
    im[..., 0] = spec[..., n // 2].real
    return re, im
