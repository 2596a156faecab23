"""Spans at the port's layer boundaries, for ``torch.profiler``.

A span is a ``torch.profiler.record_function`` range named ``<layer
module>.<what>``, so it lands in the profiler's trace beside the card's
kernels, on the same clock, and each kernel's runtime call can be put
down to the innermost span around it. A span fires only while a profiler
is running: otherwise :func:`span` returns one shared null context, and a
span costs one check. Nothing turns them on but a profiler
(``utils.profiling.trace``, or any ``torch.profiler.profile`` that
records CPU activity).

:data:`SPANS` lists every span name in the port.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["SPANS", "LAUNCH_SPAN", "span", "spanned"]

# The prefix of a kernel launch's span; ``_cuda.Kernel.span`` appends the
# kernel's name.
LAUNCH_SPAN = "ops._cuda.launch."

# Every ``_cuda.Kernel``'s name, in ``ops.hopper_fft.KERNELS``' order, then
# ``ops.convolve.KERNELS``', ``ops.polyphase.KERNELS``' and
# ``ops.demod.KERNELS``'.
_KERNELS = (
    "rfft_packed_kernel", "irfft_packed_kernel", "convolve_irfft_packed_kernel", "cfft_kernel",
    "small_cfft_kernel", "small_rfft_kernel", "small_irfft_kernel",
    "composite_l1_kernel", "composite_l2_kernel", "composite_l2_rev_kernel", "composite_l1_rev_kernel",
    "rfft_cols_kernel", "irfft_cols_kernel",
    "rfft_packed_joint_db_kernel", "irfft_packed_db_kernel", "cfft_db_kernel",
    "partitioned_accumulate_kernel", "packed_product_kernel",
    "polyphase_decimate_kernel",
    "fm_demod_kernel",
)

SPANS = (
    "models.convolver.apply",
    "models.convolver.step",
    "models.sdr.forward",
    "models.sdr.front_end",
    "models.sdr.back_end",
    "models.sdr.sharded_step",
    "stream.polyphase.decimate",
    "stream.polyphase.interpolate",
    "stream.channelizer.forward",
    "stream.channelizer.commutate",
    "stream.channelizer.branch_fir",
    "stream.demod.fm",
    "stream.ols.apply_offline",
    "stream.ols.step",
    "stream.ols.step_k",
    "stream.ols.fir_filter_ols",
    "stream.ols.frame",
    "stream.ols.fdl_shift",
    "stream.ols.trim",
    "ops.convolve.accumulate_packed",
    "ops.convolve.accumulate_partitioned",
    "ops.hopper_composite.cfft_composite",
    "ops.hopper_composite.rfft_composite",
    "ops.hopper_composite.irfft_composite",
    "api.fft",
    "api.ifft",
    "api.fft_unordered",
    "api.ifft_unordered",
    "api.fft_planes",
    "api.ifft_planes",
    "api.fft_planes_unordered",
    "api.ifft_planes_unordered",
    "api.rfft",
    "api.irfft",
    "api.rfft_unordered",
    "api.irfft_unordered",
    "api.rfft_packed",
    "api.irfft_packed",
    "api.rfft_packed_unordered",
    "api.irfft_packed_unordered",
    "api.convolve_irfft_packed",
    *(LAUNCH_SPAN + k for k in _KERNELS),
)

_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
record_function = torch.profiler.record_function

# A process's first record_function pays a one-time lookup of its ops
# (~1.5 ms of host time). Pay it at import, not in the first profiled call:
# a profiler that records CUDA alone runs the spans too (torch does not say
# cheaply which activities it records), and would read that as idle.
with record_function("utils.tracing.import"):
    pass


def span(name: str):
    """``record_function(name)`` while a profiler runs, else a shared
    null context."""
    return record_function(name) if _profiler_enabled() else _NULL


def spanned(name: str):
    """Decorator: each call of the function inside :func:`span` ``(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)

        return run

    return wrap
