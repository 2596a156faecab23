"""The work of one call of the long-IR reverb (BASELINE config 4's audio
through config 3's ``fir_filter_ols`` in one partition), for its
rooflines (``roofline.least_seconds``): what the call must do, whatever
kernels do it.

The FFT size follows ``fir_filter_ols``'s rule, frozen here: block =
max(256, next_pow2(4 taps) / 2), N = next_pow2(block + taps - 1), and a
frame keeps N - taps + 1 samples. At T = 480,000 samples and 96,000 taps:
block 262,144, N = 2^19, 428,289 samples kept a frame, so F = 2 frames a
channel.

- The whole call (:func:`call_work`). Bytes: x read once, the IRs read
  once and y written once, 4 C T 2 + 4 C taps (C = 64: 270.3 MB).
  Operations: 2.5 N log2 N for each forward row (C IRs and C F frames)
  and each inverse row (C F frames), and 8 a packed slot (a complex
  multiply) for each of C F N/2 products. At C = 64: 320 rows of 2^19
  and 128 x 2^18 products, 8.238 GFLOP, a least time of 0.1229 ms, set
  by the operations.
- The composite's column kernels (:func:`composite_work`): each row
  takes two passes (level 1 and level 2), each of which reads and writes
  8 N bytes (N float32 samples or N/2 complex slots, either way), so 16 N
  bytes and 2.5 N log2 N operations a row. 320 rows of 2^19: 2.684 GB
  and 7.969 GFLOP, a least time of 0.8013 ms, set by the bytes.
"""

from __future__ import annotations

from . import roofline
from .reference.convolution import _fast_length as _pow2


def ols_geometry(samples: int, taps: int, block: int | None = None) -> tuple[int, int]:
    """(N, frames a channel) of single-partition overlap-save on
    ``samples`` by ``taps``, with ``block`` (or its default) as
    ``fir_filter_ols`` takes it."""
    if block is None:
        block = max(256, _pow2(4 * taps) // 2)
    n = _pow2(block + taps - 1)
    return n, -(-samples // (n - taps + 1))


def _rows(channels: int, samples: int, taps: int, block: int | None) -> tuple[int, int, int]:
    """(N, forward rows, inverse rows) of one call."""
    n, frames = ols_geometry(samples, taps, block)
    return n, channels + channels * frames, channels * frames


def call_work(channels: int, samples: int, taps: int, block: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of filtering ``channels`` streams of
    ``samples`` by their own ``taps``-long IRs in one partition."""
    n, forward, inverse = _rows(channels, samples, taps, block)
    bytes_moved = 4 * channels * samples * 2 + 4 * channels * taps
    flops = (forward + inverse) * roofline.real_fft_flops(n) + 8 * inverse * (n // 2)
    return float(bytes_moved), float(flops)


def composite_work(channels: int, samples: int, taps: int, block: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of the real composite's two column passes on
    every forward and inverse row of one call."""
    n, forward, inverse = _rows(channels, samples, taps, block)
    rows = forward + inverse
    return float(rows * 2 * 8 * n), float(rows * roofline.real_fft_flops(n))
