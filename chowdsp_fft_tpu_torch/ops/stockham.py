"""Mixed-radix Stockham autosort FFT engine in plain PyTorch.

Counterpart of ``chowdsp_fft_tpu/ops/stockham.py``: radices {2,3,4,5},
every stage reads and writes contiguous blocks so the output is in natural
order without a reorder pass, real transforms use the half-length complex
FFT plus split, and transforms are unscaled (backward(forward(x)) == N*x).
It runs on CPU and CUDA tensors alike and serves every size the Hopper
kernels do not take. Its stage loop (:func:`cfft_stages`) is also the
stage loop of the kernels' plain twins in ``hopper_fft``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..plans import FFT_COMPLEX, FFT_FORWARD, FFT_REAL, FFTPlan, cached_plan

__all__ = ["cfft", "rfft", "irfft", "cfft_stages"]


def _butterfly(parts: list[torch.Tensor], sign: int) -> list[torch.Tensor]:
    """Radix-r DFT across a list of r tensors. ``sign`` is -1 forward,
    +1 backward. Radix 2 and 4 avoid multiplies by +-1/+-i; 3 and 5 are a
    dense r-point DFT."""
    r = len(parts)
    if r == 2:
        a, b = parts
        return [a + b, a - b]
    if r == 4:
        a, b, c, d = parts
        t0 = a + c
        t1 = a - c
        t2 = b + d
        t3 = (b - d) * (1j * sign)
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    w = np.exp(sign * 2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
    out = []
    for j in range(r):
        acc = parts[0]
        for k in range(1, r):
            acc = acc + parts[k] * complex(w[j, k])
        out.append(acc)
    return out


def cfft_stages(z: torch.Tensor, plan: FFTPlan, sign: int) -> torch.Tensor:
    """Run the plan's Stockham stages over the last axis of a (rows, n)
    complex64 tensor; n is the plan's complex length."""
    bsz, n = z.shape
    tables = plan.device_tables(z.device).stage_tw
    X = z.reshape(bsz, n, 1)
    for st, tw in zip(plan.stages, tables):
        r, m, s = st.radix, st.m, st.s
        Xv = X.reshape(bsz, r, m, s)
        Z = _butterfly([Xv[:, k] for k in range(r)], sign)
        # Tables hold forward-sign twiddles; backward conjugates them.
        w = tw if sign < 0 else tw.conj()
        Zt = [Z[0]] + [Z[j] * w[j][None, :, None] for j in range(1, r)]
        X = torch.stack(Zt, dim=2).reshape(bsz, m, r * s)
    return X.reshape(bsz, n)


def cfft(x: torch.Tensor, plan: FFTPlan | None = None, direction: str = FFT_FORWARD) -> torch.Tensor:
    """Complex FFT over the last axis, unscaled in both directions.
    (..., N) -> (..., N) complex64."""
    n = x.shape[-1]
    if plan is None:
        plan = cached_plan(n, FFT_COMPLEX)
    if plan.kind != FFT_COMPLEX or plan.n != n:
        raise ValueError(f"plan mismatch: plan=({plan.kind}, {plan.n}), input N={n}")
    x = x.to(torch.complex64)
    if n == 1:
        return x
    sign = -1 if direction == FFT_FORWARD else 1
    batch_shape = x.shape[:-1]
    out = cfft_stages(x.reshape(-1, n), plan, sign)
    return out.reshape(*batch_shape, n)


def _check_real_plan(plan: FFTPlan, n: int):
    if plan.kind != FFT_REAL or plan.n != n:
        raise ValueError(f"plan mismatch: plan=({plan.kind}, {plan.n}), real N={n}")


def rfft(x: torch.Tensor, plan: FFTPlan | None = None) -> torch.Tensor:
    """Real forward FFT -> canonical half spectrum of N//2 + 1 complex bins.

    Packs adjacent sample pairs into N/2 complex points, runs the
    half-length complex FFT, then splits even/odd spectra with the plan's
    exp(-2i*pi*k/N) twiddles."""
    n = x.shape[-1]
    if plan is None:
        plan = cached_plan(n, FFT_REAL)
    _check_real_plan(plan, n)
    x = x.to(torch.float32)
    m = n // 2
    batch_shape = x.shape[:-1]
    z = torch.complex(x[..., 0::2], x[..., 1::2]).reshape(-1, m)
    Z = cfft_stages(z, plan, -1) if m > 1 else z

    Zc = torch.roll(torch.flip(Z, dims=[-1]), 1, dims=-1).conj()  # conj(Z[(M-k) % M])
    E = 0.5 * (Z + Zc)
    O = -0.5j * (Z - Zc)
    w = plan.device_tables(x.device).split_tw
    main = E + w * O  # bins 0..M-1
    nyq = (E[..., :1] - O[..., :1]).real  # bin M is real
    out = torch.cat([main, torch.complex(nyq, torch.zeros_like(nyq))], dim=-1)
    return out.reshape(*batch_shape, m + 1)


def irfft(spec: torch.Tensor, plan: FFTPlan | None = None) -> torch.Tensor:
    """Unscaled inverse real FFT: irfft(rfft(x)) == N * x.
    (..., N//2+1) complex -> (..., N) float32."""
    bins = spec.shape[-1]
    n = 2 * (bins - 1)
    if plan is None:
        plan = cached_plan(n, FFT_REAL)
    _check_real_plan(plan, n)
    spec = spec.to(torch.complex64)
    m = n // 2
    batch_shape = spec.shape[:-1]
    spec = spec.reshape(-1, bins)

    Xmain = spec[..., :m]
    Xr = torch.flip(spec[..., 1:], dims=[-1]).conj()  # conj(X[M - k])
    E = 0.5 * (Xmain + Xr)
    wb = plan.device_tables(spec.device).split_tw.conj()  # exp(+2i*pi*k/N)
    O = 0.5 * wb * (Xmain - Xr)
    Z = E + 1j * O
    zt = cfft_stages(Z, plan, 1) if m > 1 else Z
    # zt == M * (x_even + i x_odd); N*x = 2M*x.
    out = torch.stack([2.0 * zt.real, 2.0 * zt.imag], dim=-1)
    return out.reshape(*batch_shape, n)
