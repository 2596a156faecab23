"""Gradients through the Hopper engine: one ``torch.autograd.Function`` per
adjoint rule of ``chowdsp_fft_tpu/ops/pallas_fft.py``'s ``jax.custom_vjp``
blocks, at the same grain.

| Function | JAX rule | forward | backward |
|---|---|---|---|
| :class:`RfftPacked` | ``_pallas_rfft_packed`` :1273, ``_rdc_fwd`` :3287 | K5, K1 or the real composite | the inverse of the half-weighted cotangent |
| :class:`IrfftPacked` | ``_pallas_irfft_packed`` :1293, ``_rdc_inv`` :3305 | K5, K2 or the composite inverse | the forward of the cotangent, weighted 2 |
| :class:`ConvolveIrfftPacked` | ``_pallas_irfft_conv`` :2114 | K3 | the unfused composition's adjoint |
| :class:`CfftPair` | ``_cfft_pair`` :2905 | K5, K4 or the composite (K6) | the opposite direction, same ``ordered`` |
| :class:`PackedProduct` | none (XLA differentiates ``ops/convolve.py``'s ops) | ``csrc/packed_product.cu`` | the packed product's adjoint, plain torch; ``ab``'s gradient passes through |
| :class:`PartitionedAccumulate` | none (XLA differentiates ``stream/ols.py``'s loop) | ``csrc/partitioned_accumulate.cu`` | the packed product's adjoint per partition, plain torch |
| :class:`PolyphaseDecimate` | none (XLA differentiates ``lax.conv_general_dilated``) | ``csrc/polyphase.cu`` | a strided transposed correlation with h, plain torch |
| :class:`FMDemod` | none (XLA differentiates ``stream/demod.py``'s ops) | ``csrc/demod.cu`` | ``gain * i z / abs(z)^2`` times the cotangent's backward difference, plain torch |

No kernel is written for a backward pass: as in the JAX package, each
backward runs the forward kernels of the opposite direction, and the glue
(the half-spectrum weight, the packed product's adjoint) is plain torch.
The JAX package's ``_rfft_packed_cols`` (:1519) wraps its v1 composite's
level 1 alone; here the whole real composite sits under
:class:`RfftPacked` and :class:`IrfftPacked` (as under ``_rdc_fwd`` and
``_rdc_inv``), so K7a and K7b need no Function of their own.

A CPU tensor takes the kernels' plain versions, forward and backward.
:class:`PackedProduct`, :class:`PartitionedAccumulate`,
:class:`PolyphaseDecimate` and :class:`FMDemod` have no kernel in their
backward. The last three's forward is the wrapper on every device;
:class:`PackedProduct`'s is the kernel wrapper, since
``convolve_accumulate_packed`` enters it only where the kernel runs.
The engine entries (``hopper_fft.rfft_packed``, ``irfft_packed``,
``convolve_irfft_packed``, ``cfft``, ``cfft_planes``) route through these
Functions only when grad mode is on and an input requires grad.

Each backward is marked ``once_differentiable``, as the JAX backward
rules call the ``_impl`` functions, which have no rule of their own: a
second derivative (``create_graph=True`` and backward again) raises.

Complex gradients: PyTorch hands a complex tensor the conjugate Wirtinger
gradient (dL/dre + i dL/dim) and the transpose of the complex transform
on that is the opposite-direction transform, unscaled; ``jax.grad`` of a
real loss with respect to a complex input returns its conjugate. On
(re, im) planes both frameworks agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

# hopper_fft imports this module for its entries; the cycle is between
# modules only, and the dispatchers are looked up at call time.
from . import convolve, demod, hopper_composite, hopper_fft, polyphase
from ..plans import FFTPlan

__all__ = [
    "needs_grad",
    "halfspec_weight",
    "packed_product_adjoint",
    "RfftPacked",
    "IrfftPacked",
    "ConvolveIrfftPacked",
    "CfftPair",
    "PackedProduct",
    "PartitionedAccumulate",
    "PolyphaseDecimate",
    "FMDemod",
]


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether an engine entry must route through a Function: grad mode on
    and some input requiring grad. Otherwise the entries take the kernels
    directly (no extra host work; CUDA-graph capture as before)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def halfspec_weight(re: torch.Tensor, im: torch.Tensor, w_pair: float):
    """``_halfspec_weight`` (pallas_fft.py:1262): slot 0 of packed planes
    holds DC (re) and Nyquist (im), one real bin each, weight 1; every
    other slot stands for a conjugate pair of bins, weight ``w_pair`` (1/2
    transposing the forward, 2 transposing the inverse). By slot, not by
    bin number: bin 0 is at index 0 in the unordered layouts too."""
    sre, sim = re * w_pair, im * w_pair
    sre[..., 0] = re[..., 0]
    sim[..., 0] = im[..., 0]
    return sre, sim


def packed_product_adjoint(gre: torch.Tensor, gim: torch.Tensor, bre: torch.Tensor, bim: torch.Tensor,
                           scale: float):
    """The adjoint of ``P = scale * A (.) B`` on packed planes
    (``convolve_accumulate_packed``) with respect to A, given the
    cotangent G of P: ``scale * G * conj(B)`` in every slot but slot 0,
    where DC and Nyquist are two real products (``scale * G.re * B.re``,
    ``scale * G.im * B.im``). With A and B swapped, the adjoint with
    respect to B."""
    re = (gre * bre + gim * bim) * scale
    im = (gim * bre - gre * bim) * scale
    re[..., 0] = gre[..., 0] * bre[..., 0] * scale
    im[..., 0] = gim[..., 0] * bim[..., 0] * scale
    return re, im


def _detached(*tensors: torch.Tensor):
    """Inputs for the kernel wrappers, which refuse tensors that require grad."""
    return tuple(t.detach() for t in tensors)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A gradient as the kernel wrappers take it: no lazy conjugate or
    negative view, contiguous, 8-byte aligned."""
    t = t.resolve_conj().resolve_neg().contiguous()
    return t.clone() if t.data_ptr() % 8 else t


class RfftPacked(torch.autograd.Function):
    """``hopper_fft.rfft_packed`` on (rows, N) f32 rows -> packed planes.
    Backward (``_pallas_rfft_packed_bwd`` :1285, ``_rdc_fwd_bwd`` :3298):
    the unscaled inverse, same ``ordered``, of the cotangent weighted 1/2
    in every slot but slot 0. Once differentiable."""

    @staticmethod
    def forward(ctx, x, plan: FFTPlan, ordered: bool):
        ctx.plan, ctx.ordered = plan, ordered
        return hopper_fft.rfft_rows(*_detached(x), plan, ordered)

    @staticmethod
    @once_differentiable
    def backward(ctx, gre, gim):
        sre, sim = halfspec_weight(gre, gim, 0.5)
        return hopper_fft.irfft_rows(sre, sim, ctx.plan, ctx.ordered), None, None


class IrfftPacked(torch.autograd.Function):
    """``hopper_fft.irfft_packed`` on packed planes (rows, N/2) x2 ->
    (rows, N) f32. Backward (``_pallas_irfft_packed_bwd`` :1303,
    ``_rdc_inv_bwd`` :3315): the forward transform of the cotangent, same
    ``ordered``, weighted 2 in every slot but slot 0. Once
    differentiable."""

    @staticmethod
    def forward(ctx, yre, yim, plan: FFTPlan, ordered: bool):
        ctx.plan, ctx.ordered = plan, ordered
        return hopper_fft.irfft_rows(*_detached(yre, yim), plan, ordered)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        re, im = hopper_fft.rfft_rows(_dense(g), ctx.plan, ctx.ordered)
        return (*halfspec_weight(re, im, 2.0), None, None)


class ConvolveIrfftPacked(torch.autograd.Function):
    """K3, ``irfft(scale * A (.) B)`` on rows: A (rows, N/2) x2, B (1 or
    rows, N/2) x2, K1 domain. Backward (``_pallas_irfft_conv_bwd`` :2126):
    the adjoint of the unfused composition, :class:`IrfftPacked`'s (K1 on
    the cotangent, weighted 2) and then the packed product's
    (:func:`packed_product_adjoint`); B's gradient is summed over the rows
    when B has one row (a shared filter). Saves A and B. Once
    differentiable."""

    @staticmethod
    def forward(ctx, are, aim, bre, bim, plan: FFTPlan, scale: float, ordered: bool):
        ctx.plan, ctx.scale, ctx.ordered = plan, scale, ordered
        args = _detached(are, aim, bre, bim)
        ctx.save_for_backward(*args)
        return hopper_fft.convolve_irfft_packed_kernel(*args, scale, plan, ordered)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        are, aim, bre, bim = ctx.saved_tensors
        gre, gim = halfspec_weight(*hopper_fft.rfft_rows(_dense(g), ctx.plan, ctx.ordered), 2.0)
        da = db = (None, None)
        if any(ctx.needs_input_grad[:2]):
            da = packed_product_adjoint(gre, gim, bre, bim, ctx.scale)
        if any(ctx.needs_input_grad[2:4]):
            db = packed_product_adjoint(gre, gim, are, aim, ctx.scale)
            if bre.shape[0] != are.shape[0]:
                db = tuple(t.sum(0, keepdim=True) for t in db)
        return (*da, *db, None, None, None)


class CfftPair(torch.autograd.Function):
    """``hopper_composite.cfft_rows`` (the complex dispatch: K5, K4 or the
    composite) on (rows, N) rows, given as one complex64 tensor ``a``
    (``b`` None) or as planes ``a``, ``b``; returns the same form.
    Backward (``_cfft_pair_bwd`` :2923): the opposite direction with the
    same ``ordered`` flag on the gradient, in the same form. Once
    differentiable."""

    @staticmethod
    def forward(ctx, a, b, plan: FFTPlan, forward: bool, ordered: bool):
        ctx.plan, ctx.forward, ctx.ordered = plan, forward, ordered
        ctx.planes = b is not None
        x = _detached(a, b) if ctx.planes else a.detach()
        return hopper_composite.cfft_rows(x, plan, forward, ordered)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        g = tuple(map(_dense, grads)) if ctx.planes else _dense(grads[0])
        out = hopper_composite.cfft_rows(g, ctx.plan, not ctx.forward, ctx.ordered)
        da, db = out if ctx.planes else (out, None)
        return da, db, None, None, None


class PackedProduct(torch.autograd.Function):
    """The packed product, ``convolve.convolve_accumulate_packed``: planes
    A, B (broadcasting against A) and an optional accumulator C (None,
    None) -> ``C + scale * A (.) B``. Backward, in plain torch with
    :func:`packed_product_adjoint`: A's and B's gradients each summed over
    the dims it was broadcast along (a filter's over the frames), C's the
    cotangent, summed likewise; ``scale`` (a number or a one-element tensor)
    gets none. Saves A and B. Once differentiable."""

    @staticmethod
    def forward(ctx, are, aim, bre, bim, cre, cim, scale):
        ab = None if cre is None else _detached(cre, cim)
        ctx.ab_shape = None if ab is None else ab[0].shape
        ctx.scale = scale.detach().reshape(()) if isinstance(scale, torch.Tensor) else scale
        args = _detached(are, aim, bre, bim)
        ctx.save_for_backward(*args)
        return convolve.packed_product_kernel(args[:2], args[2:], ab, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, gre, gim):
        are, aim, bre, bim = ctx.saved_tensors
        scale = ctx.scale.to(gre.device, gre.dtype) if isinstance(ctx.scale, torch.Tensor) else ctx.scale
        da = db = dc = (None, None)
        if any(ctx.needs_input_grad[:2]):
            da = tuple(t.sum_to_size(are.shape) for t in packed_product_adjoint(gre, gim, bre, bim, scale))
        if any(ctx.needs_input_grad[2:4]):
            db = tuple(t.sum_to_size(bre.shape) for t in packed_product_adjoint(gre, gim, are, aim, scale))
        if any(ctx.needs_input_grad[4:6]):
            dc = gre.sum_to_size(ctx.ab_shape), gim.sum_to_size(ctx.ab_shape)
        return (*da, *db, *dc, None)


class PartitionedAccumulate(torch.autograd.Function):
    """The offline FDL, ``convolve.convolve_accumulate_partitioned``:
    X (..., nb, M) x2 and H (..., P, M) x2 -> ``Y[b] = scale * sum_p
    X[b - p] (.) H[p]``. Backward, in plain torch with
    :func:`packed_product_adjoint`: ``dX[j] = scale * sum_p adj(H[p]) (.)
    G[j + p]`` and ``dH[p] = scale * sum_{b >= p} adj(X[b - p]) (.) G[b]``,
    each summed over the dims it was broadcast along (a shared filter's
    over the streams). Saves X and H. Once differentiable."""

    @staticmethod
    def forward(ctx, xre, xim, hre, him, scale: float):
        ctx.scale = scale
        args = _detached(xre, xim, hre, him)
        ctx.save_for_backward(*args)
        return convolve.convolve_accumulate_partitioned(args[:2], args[2:], scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, gre, gim):
        xre, xim, hre, him = ctx.saved_tensors
        need_x, need_h = any(ctx.needs_input_grad[:2]), any(ctx.needs_input_grad[2:4])
        nb = gre.shape[-2]
        dxre, dxim = torch.zeros_like(gre), torch.zeros_like(gim)
        dhre = gre.new_zeros(*gre.shape[:-2], hre.shape[-2], gre.shape[-1])
        dhim = torch.zeros_like(dhre)
        for p in range(min(hre.shape[-2], nb)):
            g = gre[..., p:, :], gim[..., p:, :]
            if need_x:
                dr, di = packed_product_adjoint(*g, hre[..., p, None, :], him[..., p, None, :], ctx.scale)
                dxre[..., : nb - p, :] += dr
                dxim[..., : nb - p, :] += di
            if need_h:
                dr, di = packed_product_adjoint(*g, xre[..., : nb - p, :], xim[..., : nb - p, :], ctx.scale)
                dhre[..., p, :] = dr.sum(-2)
                dhim[..., p, :] = di.sum(-2)
        dx = (dxre.sum_to_size(xre.shape), dxim.sum_to_size(xim.shape)) if need_x else (None, None)
        dh = (dhre.sum_to_size(hre.shape), dhim.sum_to_size(him.shape)) if need_h else (None, None)
        return (*dx, *dh, None)


class PolyphaseDecimate(torch.autograd.Function):
    """The decimator, ``polyphase.decimate``: x (B, T) and h (taps,) ->
    ``y[b, m] = sum_k h[k] x[b, m f - k]`` (zero state, m < T // f).
    Backward, in plain torch: ``dx[b, n] = sum_m g[b, m] h[m f - n]``, a
    strided transposed correlation with h truncated to T, and ``dh[k] =
    sum_{b, m} g[b, m] x[b, m f - k]``, one strided product a tap. Saves x
    and h. Once differentiable."""

    @staticmethod
    def forward(ctx, x, h, factor: int):
        ctx.factor = factor
        x, h = _detached(x, h)
        ctx.save_for_backward(x, h)
        return polyphase.decimate(x, h, factor)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, h = ctx.saved_tensors
        f, taps, (rows, t), m = ctx.factor, h.shape[-1], x.shape, g.shape[-1]
        dx = dh = None
        if ctx.needs_input_grad[0]:
            dx = x.new_zeros(rows, t)
            if m:
                with polyphase.fp32_convolutions():
                    # full[:, j] = sum_m g[:, m] h[m f + taps-1 - j], so dx[:, n] = full[:, n + taps-1]
                    full = F.conv_transpose1d(g[:, None, :], h.flip(-1)[None, None, :], stride=f)[:, 0]
                full = full[:, taps - 1 : taps - 1 + t]
                dx[:, : full.shape[-1]] = full
        if ctx.needs_input_grad[1]:
            xp = F.pad(x, (taps - 1, 0))  # xp[:, n + taps-1] = x[:, n], zeros before
            dh = torch.stack([(g * xp[:, taps - 1 - k :: f][:, :m]).sum() for k in range(taps)])
        return dx, dh, None


class FMDemod(torch.autograd.Function):
    """The FM discriminator, ``demod.fm_demod``: z (..., T) complex64 ->
    ``y[n] = gain * angle(z[n] conj(z[n-1]))`` (y[0] = 0 on the card).
    Backward, in plain torch: y[n] moves with z[n] by ``gain * Im(dz[n] /
    z[n])`` and y[n+1] by minus that, so ``dz[n] = gain * i z[n] / abs(z[n])^2
    * (g[n] - g[n+1])``, with g[0] and g[T] taken as 0 and, as the plain
    version's autograd gives it, no term of a step whose product z[n]
    conj(z[n-1]) is zero (nor any at a zero sample). Saves z. Once
    differentiable."""

    @staticmethod
    def forward(ctx, z, gain: float):
        ctx.gain = gain
        (z,) = _detached(z)
        ctx.save_for_backward(z)
        return demod.fm_demod(z, gain)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        m2 = z.real * z.real + z.imag * z.imag
        live = m2 > 0
        step = live.clone()  # the steps whose product is nonzero: n >= 1, z[n] and z[n-1] nonzero
        step[..., 0] = False
        step[..., 1:] &= live[..., :-1]
        gs = torch.where(step, g.to(m2.dtype), 0)  # the sums in z's precision
        diff = gs.clone()
        diff[..., :-1] -= gs[..., 1:]
        scale = torch.where(live, ctx.gain * diff / m2, 0)
        return scale * (1j * z), None
