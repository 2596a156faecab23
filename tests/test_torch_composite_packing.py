"""The real composite's Hermitian assembly as an index map: the map by
which K6 level 2 stores its grid into the ordered packed planes and
l2_rev gathers it back (``hopper_composite.packed_index``, as
``csrc/composite_fft.cu``'s ``PackedColumn`` has it), applied in torch. At
every split (A, C) the real composite runs, scattering a random level-2
grid and its DC and Nyquist lines through the map gives the plain
version's assembly (``hermitian_assembly``) bit for bit, signs of zeros
included, and gathering packed planes through it gives the plain
version's grid (``hermitian_grid``); a map without the reversal, or
without the conjugate, gives neither (at a few splits, the long-IR
cell's among them)."""

import pytest
import torch

from chowdsp_fft_tpu_torch.ops import hopper_composite as hc

SPLITS = hc.real_splits()
# The long-IR cell's split, the smallest, and non-powers of two in C.
CONTROL_SPLITS = {(1024, 512), SPLITS[0], (1920, 500), (1024, 768), (160, 128)}
ROWS = 2


@pytest.fixture(autouse=True)
def one_thread():
    """Index maps of up to 2^19 points a row are cheap on one thread; the
    tier-1 run's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unreversed(c: int, a: int):
    """The map with the second half's rows and columns in order: point
    l >= C/2 at row l - C/2, column A/2 + k1."""
    pos, conj = hc.packed_index(c, a)
    l = torch.arange(c)[:, None]
    k1 = torch.arange(1, a // 2)[None, :]
    return torch.where(l < c // 2, pos, (l - c // 2) * a + a // 2 + k1), conj


def _unconjugated(c: int, a: int):
    pos, conj = hc.packed_index(c, a)
    return pos, torch.zeros_like(conj)


MAPS = {"map": hc.packed_index, "unreversed": _unreversed, "unconjugated": _unconjugated}


def scatter(gr, gi, lines, index):
    """The kernel's store: grid columns k1 >= 1 through ``index``, packed
    columns 0 and A/2 of rows l < C/2 from the DC and Nyquist lines, and
    X[N/2] = G_dc[C/2] (real) in im of bin 0. Unwritten bins stay NaN."""
    pos, conj = index
    b, c, half_a = gr.shape
    out_r = torch.full((b, c * half_a), float("nan"))
    out_i = torch.full_like(out_r, float("nan"))
    out_r[:, pos] = gr[:, :, 1:]
    out_i[:, pos] = torch.where(conj, -gi[:, :, 1:], gi[:, :, 1:])
    g0, gny = lines[:b, : c // 2], lines[b:, : c // 2]
    rows = torch.arange(c // 2) * 2 * half_a
    out_r[:, rows], out_i[:, rows] = g0.real, g0.imag
    out_r[:, rows + half_a], out_i[:, rows + half_a] = gny.real, gny.imag
    out_i[:, 0] = lines[:b, c // 2].real
    return out_r, out_i


def gather(yre, yim, col0, index):
    """The kernel's load: grid column 0 from ``col0``, the others through
    ``index``."""
    pos, conj = index
    return (torch.cat([col0.real[:, :, None], yre[:, pos]], 2),
            torch.cat([col0.imag[:, :, None], torch.where(conj, -yim[:, pos], yim[:, pos])], 2))


def bits_equal(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


def with_zeros(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``t`` with about a tenth of its entries +0.0 and a tenth -0.0, so a
    negation's signed zeros show in the bits."""
    u = torch.rand(t.shape, generator=gen)
    return torch.where(u < 0.1, 0.0, torch.where(u < 0.2, -0.0, t))


@pytest.mark.parametrize("direction", ["store", "gather"])
@pytest.mark.parametrize("a,c", SPLITS, ids=[f"{a}x{c}" for a, c in SPLITS])
def test_packed_index_map_is_the_hermitian_assembly(a, c, direction):
    gen = torch.Generator().manual_seed(a * 4096 + c)
    maps = MAPS if (a, c) in CONTROL_SPLITS else {"map": MAPS["map"]}
    if direction == "store":
        gr = with_zeros(torch.randn(ROWS, c, a // 2, generator=gen), gen)
        gi = with_zeros(torch.randn(ROWS, c, a // 2, generator=gen), gen)
        lines = torch.complex(torch.randn(2 * ROWS, c, generator=gen), torch.randn(2 * ROWS, c, generator=gen))
        want = hc.hermitian_assembly(gr, gi, lines)
        got = {name: scatter(gr, gi, lines, index(c, a)) for name, index in maps.items()}
    else:
        yre = with_zeros(torch.randn(ROWS, a * c // 2, generator=gen), gen)
        yim = with_zeros(torch.randn(ROWS, a * c // 2, generator=gen), gen)
        col0 = torch.complex(torch.randn(ROWS, c, generator=gen), torch.randn(ROWS, c, generator=gen))
        want = hc.hermitian_grid(yre, yim, col0)
        got = {name: gather(yre, yim, col0, index(c, a)) for name, index in maps.items()}
    assert bits_equal(got.pop("map"), want)
    for control in got.values():
        assert not bits_equal(control, want)


def test_the_long_ir_split_is_covered():
    """The long-IR cell's N = 2^19 runs the split A = 1024, C = 512, and
    every control split is a real split."""
    assert hc.split_large(1 << 19, real=True) == (1024, 512)
    assert CONTROL_SPLITS <= set(SPLITS)
