"""The roofline arithmetic of the benchmark, frozen here so that a change
to the program cannot move it.

The least time the card could take for some work is the larger of two
floors: the bytes it must move (each input read once, each output
written once) over the memory rate, and its operations over the FP32
rate (the port's kernels compute in FP32 outside the tensor cores).
Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet): 3.35 TB/s of HBM3 and 67 TFLOP/s FP32. A card set below 700 W
runs below them, so a run prints the card's power limit beside every
share.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
POWER_W = 700.0


def least_seconds(bytes_moved: float, flops: float) -> float:
    """The larger of the bytes floor and the operations floor."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def real_fft_flops(n: int) -> float:
    """Operations of one real FFT of length ``n``, either way: 2.5 N log2 N."""
    return 2.5 * n * math.log2(n)


def real_fft_bytes(n: int) -> int:
    """Bytes of one real FFT row, either way: N float32 samples and N/2
    packed complex slots (two float32 planes)."""
    return 4 * n + 8 * (n // 2)


def roundtrip_work(n: int, rows: int) -> tuple[float, float]:
    """(bytes, operations) of a forward and an inverse real FFT of
    ``rows`` rows of ``n``."""
    return 2.0 * rows * real_fft_bytes(n), 2.0 * rows * real_fft_flops(n)


def partitioned_convolution_work(channels: int, samples: int, taps: int, block: int) -> tuple[float, float]:
    """(bytes, operations) of filtering ``channels`` streams of
    ``samples`` by their own ``taps``-long IRs through the uniformly
    partitioned overlap-save FDL with partitions of ``block`` (FFT length
    N = 2 block).

    Bytes: x read once, the IR bank's packed spectra (P partitions of N/2
    complex slots a channel) read once, y written once. Operations: the
    forward and the inverse FFT of every block at 2.5 N log2 N each, and
    8 a packed slot (a complex multiply-add) for every product of a block
    with a partition that the input needs: block b meets partitions
    0..min(b, P-1). The count does not depend on which kernels do the
    work."""
    n = 2 * block
    blocks = -(-samples // block)
    partitions = -(-taps // block)
    bytes_moved = 4 * channels * samples + 8 * channels * partitions * (n // 2) + 4 * channels * samples
    products = channels * sum(min(b + 1, partitions) for b in range(blocks))
    flops = 2 * channels * blocks * real_fft_flops(n) + 8 * products * (n // 2)
    return float(bytes_moved), float(flops)
