"""The port's H100 roofline calculator (chowdsp_fft_tpu_torch.utils.roofline)
against the JAX package's byte counts, and the bounds PERF.md's kernel
table takes from it.

Bytes: the JAX module's memory term at levels = 1 is input plus output
per row; on a real output it counts N/2 + 1 complex bins (the canonical
spectrum), where the packed planes hold N/2 slots (Nyquist in im[0]), so
the port's real count is 8 bytes per row lower. No TPU time enters: only
the JAX module's bytes (its seconds times its chip's memory rate)."""

import math

import pytest

from chowdsp_fft_tpu.utils import roofline as jroof
from chowdsp_fft_tpu_torch.utils import roofline as roof


def jax_bytes(n, batch, kind):
    r = jroof.fft_roofline(n, batch, kind, levels=1, ordered=False)
    return r.seconds_memory * jroof.V5E.hbm_bytes_per_s


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("n,batch", [(256, 32768), (4096, 1024), (16384, 64), (1 << 20, 64), (786432, 3)])
def test_fft_bytes_match_jax(n, batch, kind):
    got = roof.fft_roofline(n, batch, kind).bytes
    extra = 8 * batch if kind == "real" else 0  # JAX's (N/2 + 1)-th bin
    assert math.isclose(got + extra, jax_bytes(n, batch, kind), rel_tol=1e-12)


@pytest.mark.parametrize("n,batch,kind,mb,ms", [
    (4096, 1024, "real", 33.554432, 0.0100),  # K1, K2, K3
    (4096, 1024, "complex", 67.108864, 0.0200),  # K4
    (256, 32768, "complex", 134.217728, 0.0401),  # K5 complex
    (256, 32768, "real", 67.108864, 0.0200),  # K5 real forward and inverse
    (1 << 20, 64, "complex", 1073.741824, 0.3205),  # K6 at config 2's top row
    (1 << 20, 64, "real", 536.870912, 0.1603),  # K7 at config 2's top row
])
def test_kernel_table_bounds(n, batch, kind, mb, ms):
    """Every row of PERF.md's kernel table is bound by bytes."""
    r = roof.fft_roofline(n, batch, kind)
    assert math.isclose(r.bytes / 1e6, mb, rel_tol=1e-9)
    assert round(r.ms, 4) == ms
    assert r.bound_by == "bytes" and r.seconds == r.seconds_memory


@pytest.mark.parametrize("kind,length,table,ms", [
    ("complex", 1024, 0, 0.3205),  # K6 level 1 and its reverse at N=2^20, B=64
    ("complex", 1024, 1 << 20, 0.3230),  # K6 level 2 and its reverse, with the 8 MB twiddle table
    ("real", 1024, 0, 0.1603),  # K7a, K7b
])
def test_composite_level_bounds(kind, length, table, ms):
    """One composite level moves the whole array once each way, plus its
    twiddle table: bound by bytes, as PERF.md's K6/K7 rows say."""
    r = roof.level_roofline(1 << 20, 64, length, kind, table_points=table)
    assert math.isclose(r.bytes, roof.fft_roofline(1 << 20, 64, kind).bytes + 8 * table, rel_tol=1e-12)
    assert round(r.ms, 4) == ms and r.bound_by == "bytes"


def test_direct_dft_floor_is_its_own_algorithms():
    """K5's direct DFT: 8 N^2 B = 17.2 GFLOP at N=256, B=32768, a 0.256 ms
    floor that bounds the algorithm, not the function (0.0401 ms)."""
    r = roof.direct_dft_roofline(256, 32768, "complex")
    assert math.isclose(r.flops, 17.179869184e9, rel_tol=1e-12)
    assert r.bound_by == "operations" and round(r.ms, 3) == 0.256
    assert roof.direct_dft_roofline(256, 32768, "real").flops == 2 * 256 * 256 * 32768


def test_conv_roofline_counts_packed_bytes():
    """One OLS round: two real transforms on packed planes and the product
    (read A and B, write A*B), against the JAX count less its extra bin
    on each of those five spectra."""
    n, blocks = 16384, 344
    got = roof.conv_roofline(n, blocks)
    want = jroof.conv_roofline(n, blocks).seconds_memory * jroof.V5E.hbm_bytes_per_s
    assert math.isclose(got.bytes + 5 * 8 * blocks, want, rel_tol=1e-12)
    assert got.bound_by == "bytes"


def test_h100_peaks():
    assert roof.H100.hbm_bytes_per_s == 3.35e12 and roof.H100.f32_flops == 67e12
    assert roof.H100.power_w == 700.0
    r = roof.roofline(3.35e12, 67e12 * 2)
    assert r.bound_by == "operations" and r.seconds == 2.0
