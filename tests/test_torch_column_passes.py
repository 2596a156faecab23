"""The composite's column engine (``csrc/col_passes.cuh``: K6 in its four
roles, K7a and K7b) on the CPU: the launch geometry (``ops/col_passes``)
at every column length the composite's splits produce, the pass twiddle
tables against float64, the wrappers' launch arguments, and a torch-ops
emulation of the engine's passes (its pass plan, Stockham indexing,
float32 inner roots and pass tables) held against the JAX package's
two-level composite (``_cfft_composite_v2``, Pallas in interpret mode)
level by level, against its K7a (``_rfft_packed_cols_impl``) and K7b
(``_irfft_packed_cols_impl``), and K7a's against float64 at every real
column length. The kernels themselves run on the card only
(tests/test_torch_cuda.py: ``test_k6_roles_at_every_length``,
``test_k7a_at_every_length``, ``test_k7b_at_every_length``)."""

import itertools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chowdsp_fft_tpu.ops import pallas_fft
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.ops import _cuda, col_passes, row_passes, tables
from chowdsp_fft_tpu_torch.ops import hopper_composite as hc

CSRC = pathlib.Path(ct.__file__).parent / "csrc"
COMPLEX_LENGTHS, REAL_LENGTHS = hc.column_lengths()
# Every length K6 runs (complex L) and K7a, K7b run (their A/2-point transform).
CASES = [(L, ct.FFT_COMPLEX) for L in COMPLEX_LENGTHS] + [(A, ct.FFT_REAL) for A in REAL_LENGTHS]


def length_of(plan) -> int:
    return plan.n if plan.kind == ct.FFT_COMPLEX else plan.n // 2


def blocks_by_shared(g) -> int:
    """Blocks of ``g`` an SM's 228 KB of shared memory hold (each block
    also takes the 1 KB the runtime reserves)."""
    return 233472 // (g.smem_bytes + 1024)


def blocks_by_threads(g) -> int:
    """Blocks of ``g`` an SM's 2048 threads hold."""
    return 2048 // g.threads


def test_column_lengths_cover_the_splits():
    """The enumeration holds both factors of the complex splits up to 2^20
    (the K4 domain's end, MAX_CN, up to the composite's 2^20) and the real
    splits' A and C; the multiples of 128 alone give 47 complex lengths
    from 120 to 2048."""
    assert len(COMPLEX_LENGTHS) == 71 and COMPLEX_LENGTHS[0] == 18 and COMPLEX_LENGTHS[-1] == _cuda.MAX_COL
    assert len(REAL_LENGTHS) == 51 and REAL_LENGTHS[0] == 24 and REAL_LENGTHS[-1] == _cuda.MAX_COL
    of_128 = {f for n in range(_cuda.MAX_CN + 128, (1 << 20) + 1, 128) if tables.is_smooth_multiple(n)
              for f in hc.split_large(n)}
    assert len(of_128) == 47 and min(of_128) == 120 and max(of_128) == 2048
    assert of_128 <= set(COMPLEX_LENGTHS)
    for n in (1 << 20, 49152, 576, 1 << 18):
        assert set(hc.split_large(n)) <= set(COMPLEX_LENGTHS)
    assert hc.split_large(1 << 19, real=True)[0] in REAL_LENGTHS
    assert any(L % 2 for L in COMPLEX_LENGTHS) and {125, 243, 375} <= set(COMPLEX_LENGTHS)


def test_constants_are_the_sources():
    """Python's constants are the ones the kernels are built with."""
    src = (CSRC / "col_passes.cuh").read_text()
    assert int(re.search(r"constexpr int kColMaxLanes = (\d+);", src).group(1)) == col_passes.MAX_LANES
    assert int(re.search(r"constexpr int kColMaxThreads = (\d+);", src).group(1)) == col_passes.MAX_THREADS
    assert int(re.search(r"constexpr int kColNarrowThreads = (\d+);", src).group(1)) == col_passes.NARROW_THREADS
    kinds = {int(k) for k in re.findall(r"case (\d+): shared_pass<", src)} | {51}
    assert kinds == {10 * r0 + r1 for r0, r1 in col_passes.PASS_KINDS}
    assert col_passes.POINTS_PER_THREAD == row_passes.POINTS_PER_THREAD


@pytest.mark.parametrize("n,kind", CASES)
def test_geometry_at_every_length(n, kind):
    """The pass plan is the plan's stages in order, fused in pairs of the
    kernels' kinds of at most MAX_RADIX points a butterfly, and multiplies
    out to L; ceil(L/16) threads a column cover every butterfly of every
    pass. Tiles: in place (one buffer) where asked and the plan allows, as
    wide as IN_PLACE_TILE_POINTS allows (up to MAX_LANES columns); else
    two buffers, as wide as TILE_POINTS allows or wider up to
    WIDE_TILE_POINTS where the columns would move less than a 32-byte
    sector a row and plane. An in-place or narrow block leaves room for at
    least two (three) an SM in shared memory and threads, a wide one for
    one; the grid covers every column of every row."""
    plan = ct.cached_plan(n, kind)
    L = length_of(plan)
    forms = (8, 4) if kind == ct.FFT_COMPLEX else (4,)  # complex64 and planes; K7a's and K7b's real samples
    for segment, in_place, (batch, cols) in itertools.product(forms, (False, True), ((1, 1), (7, 37), (64, 1024))):
        g = col_passes.launch_geometry(plan, batch, cols, segment, in_place)
        assert tuple(r for pair in g.passes for r in pair if r != 1) == plan.radices
        assert all(pair in col_passes.PASS_KINDS for pair in g.passes)
        assert all(r0 * r1 <= col_passes.MAX_RADIX for r0, r1 in g.passes)
        assert int(np.prod([r0 * r1 for r0, r1 in g.passes])) == L
        # Fused where it can be: no two neighbouring single stages form a kind.
        assert not any(a[1] == 1 and b[1] == 1 and (a[0], b[0]) in col_passes.PASS_KINDS
                       for a, b in zip(g.passes, g.passes[1:]))
        assert g.threads_per_col == -(-L // col_passes.POINTS_PER_THREAD)
        for r0, r1 in g.passes:
            p = r0 * r1
            assert g.threads_per_col * -(-col_passes.POINTS_PER_THREAD // p) >= L // p
        assert g.threads == g.threads_per_col * g.lanes <= col_passes.MAX_THREADS
        buffer = (L * g.lanes + L * g.lanes // 32) * 8
        if in_place and col_passes.in_place_plan(L, g.passes):
            assert g.buffers == 1 and g.shape == 2 and g.smem_bytes == buffer
            assert g.passes[0] == (4, 4) and all(p == (4, 4) for p in g.passes[1:-1])
            assert g.lanes == min(col_passes.MAX_LANES, 1 << int(np.log2(col_passes.IN_PLACE_TILE_POINTS // L)))
            assert blocks_by_shared(g) >= 2 and blocks_by_threads(g) >= 2
        else:
            assert g.buffers == 2 and g.smem_bytes == 2 * buffer <= row_passes.SMEM_LIMIT
            narrow = min(col_passes.MAX_LANES, 1 << int(np.log2(col_passes.TILE_POINTS // L)))
            wide = min(col_passes.MAX_LANES, 1 << int(np.log2(col_passes.WIDE_TILE_POINTS // L)))
            want = narrow if narrow * segment >= col_passes.SECTOR_BYTES else min(wide, col_passes.SECTOR_BYTES // segment)
            assert g.lanes == want
            assert g.lanes * segment >= col_passes.SECTOR_BYTES or g.lanes == wide
            if L * g.lanes <= col_passes.TILE_POINTS:
                assert g.shape == 0 and g.threads <= col_passes.NARROW_THREADS
                assert blocks_by_shared(g) >= 3 and blocks_by_threads(g) >= 3
            else:
                assert g.shape == 1 and blocks_by_shared(g) >= 1
        assert g.grid == batch * -(-cols // g.lanes)
        assert len(g.flat_passes) == 2 * len(g.passes)
    if kind == ct.FFT_REAL:  # K7a and K7b take the tile of their role
        for k in (hc.K7A, hc.K7B):
            g = col_passes.launch_geometry(plan, 7, 37, 4, hc.in_place_role(k, 1))
            assert g.buffers == (1 if hc.in_place_role(k, 1) and col_passes.in_place_plan(L, g.passes) else 2)


def test_in_place_roles():
    """The wrappers' choice of tile per kernel (measured: PERF.md §6)."""
    assert hc.in_place_role(hc.K6_L1, 2) and hc.in_place_role(hc.K6_L2, 1) and hc.in_place_role(hc.K6_L2_REV, 2)
    assert not hc.in_place_role(hc.K6_L2_REV, 1) and not hc.in_place_role(hc.K6_L1_REV, 2)
    assert not hc.in_place_role(hc.K7B, 1)
    assert hc.in_place_role(hc.K7A, 1)
    assert col_passes.in_place_plan(1024, col_passes.pass_plan(ct.cached_plan(1024).radices))
    assert not col_passes.in_place_plan(48, col_passes.pass_plan(ct.cached_plan(48).radices))  # last pass (3,1)
    assert not col_passes.in_place_plan(1000, col_passes.pass_plan(ct.cached_plan(1000).radices))  # 16 does not divide


@pytest.mark.parametrize("radices,passes", [
    ((4, 4, 4, 4, 4), ((4, 4), (4, 4), (4, 1))),
    ((4, 2, 5, 5, 5), ((4, 2), (5, 1), (5, 1), (5, 1))),
    ((4, 3, 3, 5), ((4, 3), (3, 5))),
    ((3, 5, 5, 5), ((3, 5), (5, 1), (5, 1))),
    ((4, 2, 3, 3, 3, 5), ((4, 2), (3, 3), (3, 5))),
    ((4, 4, 2, 3, 3, 3), ((4, 4), (2, 3), (3, 3))),
    ((4, 5), ((4, 5),)),
])
def test_pass_plan_fuses_what_fits(radices, passes):
    assert col_passes.pass_plan(radices) == passes


@pytest.mark.parametrize("n,kind", [(1024, ct.FFT_COMPLEX), (375, ct.FFT_COMPLEX), (1080, ct.FFT_COMPLEX),
                                    (1024, ct.FFT_REAL)])
def test_pass_twiddles_are_float64_roots(n, kind):
    """Each pass's table holds W_L^(j*p*s) at [j*m + p] for the column
    pass plan, rounded once from float64; the device copy is the same."""
    plan = ct.cached_plan(n, kind)
    L = length_of(plan)
    table = row_passes.pass_twiddles(plan.radices, L, col_passes.pass_plan(plan.radices))
    s, off = 1, 0
    for r0, r1 in col_passes.pass_plan(plan.radices):
        P = r0 * r1
        m = L // (P * s)
        j, p = np.meshgrid(np.arange(P), np.arange(m), indexing="ij")
        want = np.exp(-2j * np.pi * ((j * p * s) % L) / L)
        np.testing.assert_array_equal(table[off: off + P * m].reshape(P, m), want.astype(np.complex64))
        off, s = off + P * m, s * P
    assert off == table.size
    assert torch.equal(col_passes.device_twiddles(plan.n, plan.kind, plan.radices, "cpu"), torch.from_numpy(table))


@pytest.mark.parametrize("a", REAL_LENGTHS)
@pytest.mark.parametrize("which", ["k7a", "k7b"])
def test_real_column_wrappers_launch_the_column_engine(monkeypatch, which, a):
    """K7a's and K7b's wrappers hand their C entries the arguments their
    signatures name: the tensors, batch, A, C, the A/2-point plan's
    radices, pass plan and pass twiddles, the split table, and the launch
    geometry of their role over the C columns (ragged). Driven on meta
    tensors, so only the wrapper's own logic runs."""
    calls = []
    monkeypatch.setattr(hc, "takes_plain", lambda *args: False)
    monkeypatch.setattr(hc, "launch", lambda kernel, entry, dev, *args: calls.append((kernel, entry, args)))
    plan = ct.cached_plan(a, ct.FFT_REAL)
    meta = torch.device("meta")
    rows, cols = 7, 37
    if which == "k7a":
        out = hc.rfft_cols(torch.empty((rows, a, cols), device=meta), plan)
        assert [tuple(t.shape) for t in out] == [(rows, cols, a // 2)] * 2
        kernel, entry = hc.K7A, "k7a_rfft_cols"
    else:
        p = torch.empty((rows, cols, a // 2), device=meta)
        assert tuple(hc.irfft_cols(p, p, plan).shape) == (rows, a, cols)
        kernel, entry = hc.K7B, "k7b_irfft_cols"
    [(k, e, args)] = calls
    g = col_passes.launch_geometry(plan, rows, cols, 4, hc.in_place_role(kernel, 1))
    assert k is kernel and e == entry
    assert len(args) + 1 == len(_cuda._SIGNATURES[entry])  # the stream comes last
    assert args[3:6] == (rows, a, cols) and args[7] == len(plan.radices) and args[9] == len(g.passes)
    assert args[-4:] == g.args


def test_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        col_passes.launch_geometry(ct.cached_plan(16384, ct.FFT_COMPLEX), 1, 1, 8, False)
    with pytest.raises(ValueError):
        col_passes.launch_geometry(ct.cached_plan(2, ct.FFT_REAL), 1, 1, 4, False)  # one point


# ---------------------------------------------------------------------------
# The emulation: the column engine's arithmetic in torch ops
# ---------------------------------------------------------------------------


def _roots(q: int, sign: int) -> torch.Tensor:
    """The kernels' inner roots exp(sign*2i*pi*e/q), float32."""
    e = np.arange(q)
    return torch.from_numpy(np.exp(sign * 2j * np.pi * e / q).astype(np.complex64))


def _dft(v: torch.Tensor, r: int, dim: int, sign: int) -> torch.Tensor:
    """Radix-r butterflies along ``dim``, roots as stockham.cuh's."""
    w = _roots(r, sign)[(np.arange(r)[:, None] * np.arange(r)[None, :]) % r]
    return torch.movedim(torch.tensordot(torch.movedim(v, dim, -1), w.T, dims=1), -1, dim)


def _factored(tw: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """The kernels' twiddles of a pass from its (P, m) table: bin
    j = j1*R0 + j0 takes row j0 times row j1*R0 (one float32 product
    where neither is row 0)."""
    out = tw.clone()
    for j1 in range(1, r1):
        for j0 in range(1, r0):
            out[j1 * r0 + j0] = tw[j0] * tw[j1 * r0]
    return out


def engine_passes(x: torch.Tensor, plan, forward: bool) -> torch.Tensor:
    """The column engine's transform of (rows, L) complex64 (one column a
    row), pass by pass as col_passes.cuh computes it: a pass of radix
    P = R0*R1 at stride s reads x[k*(L/P) + u] (u = p*s + q), runs the
    R0-point stage with inner twiddles W_P^(j0*p'), then the R1-point
    stage, multiplies output j = j1*R0 + j0 by W_L^(j*p*s) from the pass
    table (at [j*m + p], conjugated backward; rows j0 and j1*R0 multiplied
    where both are past row 0) and writes x[p*P*s + j*s + q]."""
    sign = -1 if forward else 1
    L, rows = x.shape[-1], x.shape[0]
    passes = col_passes.pass_plan(plan.radices)
    table = torch.from_numpy(row_passes.pass_twiddles(plan.radices, L, passes))
    if not forward:
        table = table.conj()
    s = 1
    for r0, r1 in passes:
        P = r0 * r1
        m = L // (P * s)
        v = _dft(x.reshape(rows, r0, r1, m, s), r0, 1, sign)  # (rows, j0, p', m, s)
        if r1 > 1:
            inner = _roots(P, sign)[np.arange(r0)[:, None] * np.arange(r1)[None, :]]
            v = _dft(v * inner[None, :, :, None, None], r1, 2, sign)  # (rows, j0, j1, m, s)
            v = v.transpose(1, 2)  # output bin j = j1*R0 + j0
        tw, table = table[: P * m].reshape(P, m), table[P * m:]
        v = v.reshape(rows, P, m, s) * _factored(tw, r0, r1)[None, :, :, None]
        x = v.permute(0, 2, 1, 3).reshape(rows, L)
        s *= P
    return x


def emulate_level1(x: torch.Tensor, plan, forward: bool) -> torch.Tensor:
    """K6 l1 (forward: (B, A, C) -> (B, C, A)) and l1_rev (backward:
    (B, C, A) -> (B, A, C)) on the emulated engine."""
    b, d1, d2 = x.shape
    if forward:
        return engine_passes(x.transpose(1, 2).reshape(b * d2, d1), plan, True).reshape(b, d2, d1)
    return engine_passes(x.reshape(b * d1, d2), plan, False).reshape(b, d1, d2).transpose(1, 2)


def emulate_level2(x: torch.Tensor, tw: torch.Tensor, plan, forward: bool) -> torch.Tensor:
    """K6 l2 (twiddle, then column FFTs of (B, C, M)) and l2_rev (inverse
    column FFTs, then twiddle) on the emulated engine."""
    b, c, m = x.shape
    if forward:
        x = x * tw
    y = engine_passes(x.transpose(1, 2).reshape(b * m, c), plan, forward).reshape(b, m, c).transpose(1, 2)
    return y if forward else y * tw


def emulate_irfft_cols(yre: torch.Tensor, yim: torch.Tensor, plan) -> torch.Tensor:
    """K7b on the emulated engine: (B, C, A/2) packed planes -> the merge
    (the DC slot's imaginary part is the Nyquist bin) -> the inverse
    A/2-point passes -> 2 (re, im) interleaved down the columns (B, A, C)."""
    b, c, h = yre.shape
    x = torch.complex(yre, yim).reshape(b * c, h)
    k = torch.arange(h)
    xk = torch.where(k == 0, torch.complex(x.real, torch.zeros_like(x.real)), x)
    xr = torch.where(k == 0, torch.complex(x[:, :1].imag, torch.zeros_like(x[:, :1].imag)),
                     torch.conj(x[:, (h - k) % h]))
    w = torch.complex(torch.from_numpy(plan.rfft_tw_re), torch.from_numpy(plan.rfft_tw_im))
    z = 0.5 * (xk + xr) + 1j * (torch.conj(w) * (0.5 * (xk - xr)))
    zt = engine_passes(z, plan, False)
    return (2 * torch.stack([zt.real, zt.imag], -1)).reshape(b, c, 2 * h).transpose(1, 2)


def emulate_rfft_cols(x: torch.Tensor, plan) -> tuple[torch.Tensor, torch.Tensor]:
    """K7a on the emulated engine: (B, A, C) f32 -> z_h = x[2h] + i x[2h+1]
    down each column -> the forward A/2-point passes -> the split
    (stockham.cuh split_bin: X[k] = E + w O from Z[k] and conj Z[H-k],
    w the plan's float32 split table; bin 0 holds DC = Re Z0 + Im Z0 and
    the Nyquist bin Re Z0 - Im Z0) -> packed planes (B, C, A/2)."""
    b, a, c = x.shape
    h = a // 2
    z = torch.complex(x[:, 0::2], x[:, 1::2]).transpose(1, 2).reshape(b * c, h)
    zt = engine_passes(z, plan, True)
    k = torch.arange(h)
    zc = torch.conj(zt[:, (h - k) % h])
    w = torch.complex(torch.from_numpy(plan.rfft_tw_re), torch.from_numpy(plan.rfft_tw_im))
    d = zt - zc
    o = torch.complex(0.5 * d.imag, -0.5 * d.real)  # -i/2 * d
    split = 0.5 * (zt + zc) + w * o
    re = torch.where(k == 0, zt.real + zt.imag, split.real)
    im = torch.where(k == 0, zt.real - zt.imag, split.imag)
    return re.reshape(b, c, h), im.reshape(b, c, h)


def packed_cols64(x: np.ndarray) -> np.ndarray:
    """float64 packed planes of the real DFT down each column of (B, A, C)
    ``x``, as (B, C, A) [re | im], the Nyquist bin in im's slot 0."""
    a = x.shape[1]
    spec = np.fft.rfft(x.astype(np.float64), axis=1).transpose(0, 2, 1)
    im = spec.imag[..., : a // 2].copy()
    im[..., 0] = spec[..., a // 2].real
    return np.concatenate([spec.real[..., : a // 2], im], -1)


def _spy_levels(monkeypatch):
    """Record every output of JAX's _v2_call (the composite's two levels)."""
    calls = []
    real = pallas_fft._v2_call

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(tuple(np.asarray(o) for o in out))
        return out

    monkeypatch.setattr(pallas_fft, "_v2_call", spy)
    return calls


def _c(pair) -> torch.Tensor:
    return torch.complex(torch.from_numpy(pair[0].copy()), torch.from_numpy(pair[1].copy()))


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.to(torch.complex128) - want.to(torch.complex128)).abs().max())


@pytest.mark.parametrize("n", [16384, 98304])
@pytest.mark.parametrize("forward", [True, False])
def test_emulation_matches_jax_level_by_level(monkeypatch, n, forward):
    """Each level of the emulated engine, on JAX's input to that level,
    against JAX's output of it, within 2e-7*N: N = 16384 (128 x 128, pass
    plan (4,4),(4,2)) and N = 98304 (384 x 256: the 384-point columns'
    plan (4,4),(4,2),(3,1) has an odd radix)."""
    a, c = hc.split_large(n)
    assert (a, c) == pallas_fft._split_large(n) and (n == 16384 or 3 in ct.cached_plan(a).radices)
    rng = np.random.default_rng(n + forward)
    z = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    calls = _spy_levels(monkeypatch)
    pallas_fft._cfft_composite_v2(jnp.asarray(z.real), jnp.asarray(z.imag), n, forward)
    assert len(calls) == 2
    mid, out = _c(calls[0]), _c(calls[1])
    pa, pc = ct.cached_plan(a, ct.FFT_COMPLEX), ct.cached_plan(c, ct.FFT_COMPLEX)
    tw = hc.twiddle(n, forward, "cpu")
    zt = torch.from_numpy(z)
    if forward:
        got_mid = emulate_level1(zt.reshape(2, a, c), pa, True)
        got_out = emulate_level2(mid.reshape(2, c, a), tw, pc, True)
    else:
        got_mid = emulate_level2(zt.reshape(2, c, a), tw, pc, False)
        got_out = emulate_level1(mid.reshape(2, c, a), pa, False)
    scale = 1.0 if forward else 1.0 / n
    assert _err(got_mid.reshape(mid.shape) * scale, mid * scale) <= 2e-7 * n
    assert _err(got_out.reshape(out.shape) * scale, out * scale) <= 2e-7 * n


def test_emulated_k7b_matches_jax():
    """K7b's emulation (merge, inverse passes, even and odd samples)
    against JAX's _irfft_packed_cols_impl at A = 256, C = 128, within
    2e-7*A, on the packed spectrum of unit-scale columns."""
    a, c = 256, 128
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, a, c)).astype(np.float32)
    spec = np.fft.rfft(x.astype(np.float64), axis=1)  # (2, A/2 + 1, C)
    re = np.ascontiguousarray(spec[:, : a // 2].real.transpose(0, 2, 1)).astype(np.float32)
    im = np.ascontiguousarray(spec[:, : a // 2].imag.transpose(0, 2, 1)).astype(np.float32)
    im[:, :, 0] = spec[:, a // 2].real
    want = np.asarray(pallas_fft._irfft_packed_cols_impl(jnp.asarray(re), jnp.asarray(im), a))
    got = emulate_irfft_cols(torch.from_numpy(re), torch.from_numpy(im), ct.cached_plan(a, ct.FFT_REAL))
    assert float(np.abs(got.numpy() - want).max()) / a <= 2e-7 * a
    assert float(np.abs(got.numpy() / a - x).max()) <= 2e-7 * a


@pytest.mark.parametrize("b,a,c", [(2, 256, 256), (2, 384, 128), (1, 640, 128)])
def test_emulated_k7a_matches_jax(b, a, c):
    """K7a's emulation (loads, forward passes, split) against JAX's
    _rfft_packed_cols_impl, within 2e-7*A: (2, 256, 256), and A = 384 and
    640, whose A/2-point plans end in the odd-radix passes (4,3) and
    (4,5)."""
    plan = ct.cached_plan(a, ct.FFT_REAL)
    assert a == 256 or {3, 5} & set(plan.radices)
    x = np.random.default_rng(a + c).standard_normal((b, a, c)).astype(np.float32)
    jr, ji = (np.asarray(v) for v in pallas_fft._rfft_packed_cols_impl(jnp.asarray(x), a))
    re, im = emulate_rfft_cols(torch.from_numpy(x), plan)
    assert re.shape == im.shape == (b, c, a // 2)
    assert max(float(np.abs(re.numpy() - jr).max()), float(np.abs(im.numpy() - ji).max())) <= 2e-7 * a
    got = np.concatenate([re.numpy(), im.numpy()], -1)
    assert float(np.abs(got - packed_cols64(x)).max()) <= 2e-7 * a


@pytest.mark.parametrize("a", REAL_LENGTHS)
def test_emulated_k7a_matches_float64(a):
    """K7a's emulation at every real column length A, on 2 batch rows of 5
    columns of unit-scale samples, within 2e-7*A of float64; zeroing the
    Nyquist slot (im[..., 0]) breaks it."""
    x = np.random.default_rng(a).standard_normal((2, a, 5)).astype(np.float32)
    re, im = emulate_rfft_cols(torch.from_numpy(x), ct.cached_plan(a, ct.FFT_REAL))
    got = np.concatenate([re.numpy(), im.numpy()], -1)
    ref = packed_cols64(x)
    assert float(np.abs(got - ref).max()) <= 2e-7 * a
    got[..., a // 2] = 0
    assert float(np.abs(got - ref).max()) > 2e-7 * a
