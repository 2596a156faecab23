"""Each cell's roofline bytes and operations against numbers worked out
by hand."""

import math

import pytest

from portbench import roofline


def test_roundtrip_at_4096_rows():
    bytes_moved, flops = roofline.roundtrip_work(4096, 4096)
    # a row each way: 4 N bytes in, 2 planes of N/2 float32 out
    assert bytes_moved == 2 * 4096 * (4 * 4096 + 8 * 2048) == 268_435_456
    assert flops == 2 * 4096 * 2.5 * 4096 * 12 == 1_006_632_960
    assert bytes_moved / roofline.HBM_BYTES_PER_S > flops / roofline.FP32_FLOPS  # bytes bound it
    assert roofline.least_seconds(bytes_moved, flops) == pytest.approx(268_435_456 / 3.35e12)  # 80.1 us


def test_roundtrip_at_1024_rows_is_a_quarter():
    b4, f4 = roofline.roundtrip_work(4096, 4096)
    b1, f1 = roofline.roundtrip_work(4096, 1024)
    assert (b1, f1) == (b4 / 4, f4 / 4)


def test_reverb_apply():
    bytes_moved, flops = roofline.partitioned_convolution_work(64, 480_000, 96_000, 4096)
    x = y = 64 * 480_000 * 4
    spectra = 64 * 24 * 4096 * 2 * 4  # 24 partitions of 4096 packed slots, two float32 planes
    assert bytes_moved == x + spectra + y == 296_091_648
    # 118 blocks a channel; block b meets min(b + 1, 24) partitions
    products = 64 * (sum(range(1, 25)) + (118 - 24) * 24)
    assert products == 163_584
    ffts = 2 * 64 * 118 * 2.5 * 8192 * 13
    assert flops == ffts + 8 * 4096 * products == pytest.approx(9.381609472e9)
    assert flops / roofline.FP32_FLOPS > bytes_moved / roofline.HBM_BYTES_PER_S  # operations bound it
    assert roofline.least_seconds(bytes_moved, flops) == pytest.approx(9.381609472e9 / 67e12)  # 140 us


def test_fft_counts():
    assert roofline.real_fft_flops(8192) == 2.5 * 8192 * 13
    assert roofline.real_fft_bytes(8192) == 8192 * 8
    assert math.isclose(roofline.least_seconds(3.35e12, 0.0), 1.0)
