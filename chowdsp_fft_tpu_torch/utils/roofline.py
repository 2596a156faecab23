"""Roofline bounds on an NVIDIA H100 (counterpart of
``chowdsp_fft_tpu/utils/roofline.py``).

The least time the card could take for a function is the larger of two
floors: the bytes it must move (each input read once, each output written
once) over the memory rate, and the operations it must do over the peak
rate for their type. Every kernel of the port computes in FP32 outside the
tensor cores. Published peaks of the H100 SXM at its 700 W limit
(NVIDIA's data sheet): 3.35 TB/s of HBM3 and 67 TFLOP/s FP32. A card set
below 700 W runs below them; report the card's ``nvidia-smi`` name and
power limit beside any share of a bound.

Not ported from the TPU module: the MXU pass model of the merge matmul,
the serial-phase sum and the 32 MB live-footprint law (TPU hardware
terms).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "ChipSpec", "H100", "Roofline", "roofline", "fft_roofline", "level_roofline", "conv_roofline",
    "direct_dft_roofline", "H100_NVLINK_BYTES_PER_S", "HOP_LATENCY_S", "halo_weak_scaling",
]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bytes_per_s: float
    f32_flops: float  # FP32 FLOP/s outside the tensor cores
    power_w: float  # the power limit the peaks assume


H100 = ChipSpec(name="H100 SXM", hbm_bytes_per_s=3.35e12, f32_flops=67e12, power_w=700.0)

# NVLink 4 of the H100 SXM: 900 GB/s a card in both directions together
# (NVIDIA's data sheet), 450 GB/s each way. A data-sheet figure, not a
# measurement: no run of this repository has had two cards.
H100_NVLINK_BYTES_PER_S = 450e9
HOP_LATENCY_S = 1e-6  # the model's fixed cost of one halo hop (assumed, as the JAX model's)


@dataclasses.dataclass(frozen=True)
class Roofline:
    bytes: float
    flops: float
    seconds_memory: float
    seconds_compute: float

    @property
    def bound_by(self) -> str:
        """Which floor bounds the function: "bytes" or "operations"."""
        return "bytes" if self.seconds_memory >= self.seconds_compute else "operations"

    @property
    def seconds(self) -> float:
        return max(self.seconds_memory, self.seconds_compute)

    @property
    def ms(self) -> float:
        return 1e3 * self.seconds


def roofline(bytes_moved: float, flops: float, chip: ChipSpec = H100) -> Roofline:
    """The bound of a function that moves ``bytes_moved`` and does
    ``flops`` FP32 operations."""
    return Roofline(
        bytes=float(bytes_moved),
        flops=float(flops),
        seconds_memory=bytes_moved / chip.hbm_bytes_per_s,
        seconds_compute=flops / chip.f32_flops,
    )


def _fft_flops(n: int, kind: str) -> float:
    """FFT operations per row: 5 N log2 N complex, 2.5 N log2 N real."""
    per = 2.5 if kind == "real" else 5.0
    return per * n * math.log2(max(2, n))


def fft_bytes(n: int, kind: str) -> int:
    """Bytes per row in and out: a real row is N float32 samples in and
    N/2 packed complex slots (two float32 planes) out; a complex row is N
    complex64 points each way."""
    if kind == "real":
        return 4 * n + 8 * (n // 2)
    return 16 * n


def fft_roofline(n: int, batch: int, kind: str = "real", chip: ChipSpec = H100) -> Roofline:
    """Bound of a batched FFT of length ``n`` (forward or inverse: the same
    bytes and operations)."""
    return roofline(batch * fft_bytes(n, kind), batch * _fft_flops(n, kind), chip)


def level_roofline(n: int, batch: int, length: int, kind: str = "complex", table_points: int = 0,
                   chip: ChipSpec = H100) -> Roofline:
    """Bound of one level of the two-level composite on ``batch`` rows of
    ``n``: the whole array in and out once (:func:`fft_bytes`), its
    complex64 twiddle table of ``table_points`` once, and the FFT flops of
    length-``length`` columns (5 or 2.5 per point per log2 ``length``)."""
    per = 2.5 if kind == "real" else 5.0
    return roofline(batch * fft_bytes(n, kind) + 8 * table_points, batch * per * n * math.log2(length), chip)


def direct_dft_roofline(n: int, batch: int, kind: str = "complex", chip: ChipSpec = H100) -> Roofline:
    """Bound of the direct DFT's own algorithm (K5): 8 N^2 operations per
    complex row, 2 N^2 per real row, with the FFT's bytes. The function's
    bound is :func:`fft_roofline`; this is the floor of the algorithm."""
    per = 2.0 if kind == "real" else 8.0
    return roofline(batch * fft_bytes(n, kind), batch * per * n * n, chip)


def conv_roofline(n_fft: int, batch_blocks: int, chip: ChipSpec = H100) -> Roofline:
    """Bound of one overlap-save round per block of ``n_fft`` samples:
    forward and inverse real FFTs (packed planes) plus the spectral
    product (read A and B, write the product; 6 operations per bin)."""
    spec = 8 * (n_fft // 2)
    bytes_moved = batch_blocks * (2 * fft_bytes(n_fft, "real") + 3 * spec)
    flops = batch_blocks * (2 * _fft_flops(n_fft, "real") + 6 * (n_fft // 2))
    return roofline(bytes_moved, flops, chip)


def halo_weak_scaling(
    per_device_samples: int,
    taps: int,
    block: int = 1024,
    chip: ChipSpec = H100,
    link_bytes_per_s: float = H100_NVLINK_BYTES_PER_S,
    overlap_comm: bool = False,
) -> dict:
    """Predicted weak-scaling efficiency of the time-sharded partitioned
    FIR (``parallel.sharded_partitioned_fir``) on a ring of cards: a
    model, never a measurement.

    Each card holds a contiguous time shard and receives a (taps-1)-sample
    float32 halo from its left neighbour in one hop an application, so the
    traffic does not grow with the number of cards and the model does not
    depend on it: efficiency = t_comp / (t_comp + t_halo) with the hop in
    series, or min(1, t_comp / max(t_comp, t_halo)) with the hop
    overlapped by the main filter (the structure ``sharded.py`` keeps).
    t_comp is the card's bound for the shard's overlap-save rounds
    (:func:`conv_roofline`), t_halo the halo's bytes over the link's
    data-sheet rate plus :data:`HOP_LATENCY_S`.
    """
    n_fft = 2 * block
    blocks = -(-per_device_samples // block)
    t_comp = conv_roofline(n_fft, blocks, chip).seconds
    t_halo = (taps - 1) * 4 / link_bytes_per_s + HOP_LATENCY_S
    if overlap_comm:
        eff = min(1.0, t_comp / max(t_comp, t_halo))
    else:
        eff = t_comp / (t_comp + t_halo)
    return {
        "per_device_samples": per_device_samples,
        "taps": taps,
        "t_compute_s": t_comp,
        "t_halo_s": t_halo,
        "efficiency": eff,
    }
