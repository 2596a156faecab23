"""The row engine (``csrc/row_passes.cuh``) of K1-K4 on the CPU: the
launch geometry (``ops/row_passes.launch_geometry``) at every size of both
domains, and a numpy model of the engine's passes (the same pass plan,
Stockham indexing, float32 inner roots and root table as the kernels)
against float64 at every size, ordered and unordered, with K1's split;
and the packed real inverse of K2/K3/K2-db on it (the first exchange
with K3's product, the merge in the first pass's reads, the backward
passes, the store of 2 z) against float64 and against the JAX package's
K2/K3 in interpret mode, with the wrappers' launch arguments at every
size. The kernels themselves run on the card only
(tests/test_torch_cuda.py: ``test_k1_at_every_size``,
``test_k2_k3_at_every_size``, ``test_k4_at_every_size``)."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.ops import hopper_cfft, hopper_fft, row_passes, tables

CSRC = pathlib.Path(ct.__file__).parent / "csrc"
REAL_SIZES = [n for n in range(257, hopper_fft.MAX_N + 1) if hopper_fft._in_domain(n)]
COMPLEX_SIZES = [n for n in range(257, hopper_cfft.MAX_CN + 1) if hopper_cfft.in_domain(n)]
CASES = [(n, ct.FFT_REAL) for n in REAL_SIZES] + [(n, ct.FFT_COMPLEX) for n in COMPLEX_SIZES]


def test_domains_are_the_kernels():
    assert len(REAL_SIZES) == 36 and REAL_SIZES[0] == 384 and REAL_SIZES[-1] == 16384
    assert len(COMPLEX_SIZES) == 33 and COMPLEX_SIZES[-1] == 13824


def test_points_per_thread_is_the_sources():
    """Python's constants are the ones the kernels are built with (the
    library reports kRowPoints on the card: chip_smoke.py's phase 1)."""
    src = (CSRC / "row_passes.cuh").read_text()
    assert int(re.search(r"constexpr int kRowPoints = (\d+);", src).group(1)) == row_passes.POINTS_PER_THREAD
    stockham = (CSRC / "stockham.cuh").read_text()
    assert int(re.search(r"constexpr int kMaxSmemBytes = (\d+);", stockham).group(1)) == row_passes.SMEM_LIMIT


@pytest.mark.parametrize("n,kind", CASES)
def test_geometry_at_every_size(n, kind):
    """The pass plan fuses the plan's stages in order and multiplies out to
    L; the threads cover every row with 16 points a thread; a block fits."""
    plan = ct.cached_plan(n, kind)
    L = row_passes.row_points(plan)
    for rows in (1, 7, 1000, 7552):
        g = row_passes.launch_geometry(plan, rows)
        stages = [r for pair in g.passes for r in pair if r != 1]
        assert tuple(stages) == plan.radices
        assert all(r1 != 1 for _, r1 in g.passes[:-1])  # pairs, a lone stage only at the end
        assert int(np.prod([r0 * r1 for r0, r1 in g.passes])) == L
        assert g.threads_per_row * row_passes.POINTS_PER_THREAD == L
        assert g.threads == g.rows_per_block * g.threads_per_row <= 1024
        assert g.threads >= min(row_passes.MIN_BLOCK_THREADS, g.threads_per_row)
        assert g.smem_bytes == g.rows_per_block * 2 * (L + L // 32) * 8 <= row_passes.SMEM_LIMIT
        assert (g.grid - 1) * g.rows_per_block < rows <= g.grid * g.rows_per_block
        assert len(g.flat_passes) == 2 * len(g.passes)


def _inner(q: int, sign: int = -1) -> np.ndarray:
    """The kernels' inner roots: exp(sign*2i*pi*e/q) in float32 (the
    backward roots are the forward ones with the sine negated)."""
    e = np.arange(q)
    w = np.exp(-2j * np.pi * e / q).astype(np.complex64)
    return w if sign < 0 else np.conj(w)


def _dft(v: np.ndarray, r: int, sign: int = -1) -> np.ndarray:
    """Radix-r butterflies along axis 1 (float32 roots, as stockham.cuh's)."""
    w = _inner(r, sign)[(np.arange(r)[:, None] * np.arange(r)[None, :]) % r]
    return np.einsum("jk,bk...->bj...", w, v).astype(np.complex64)


def engine_model(x: np.ndarray, plan, sign: int = -1) -> np.ndarray:
    """The row engine's transform of (rows, L) complex64 rows, forward
    (sign -1) or backward (+1), pass by pass as row_passes.cuh computes
    it: a pass of radix P = R0*R1 at stride s reads x[k*(L/P) + u]
    (u = p*s + q), runs the R0-point stage with inner twiddles W_P^(j*p'),
    then the R1-point stage, multiplies output j by the pass table's
    W_L^(j*p*s) (at [j*m + p]; conjugated backward) and writes
    x[p*P*s + j*s + q]."""
    L = x.shape[-1]
    rows = x.shape[0]
    table = row_passes.pass_twiddles(plan.radices, L)
    if sign > 0:
        table = np.conj(table)
    s = 1
    for r0, r1 in row_passes.pass_plan(plan.radices):
        P = r0 * r1
        m = L // (P * s)
        v = x.reshape(rows, r0, r1, m, s)  # k = k0*R1 + p', then (p, q)
        v = _dft(v, r0, sign)  # over k0: (rows, j0, p', m, s)
        if r1 > 1:
            v = v * _inner(P, sign)[(np.arange(r0)[:, None] * np.arange(r1)[None, :])][None, :, :, None, None]
            v = _dft(np.swapaxes(v, 1, 2), r1, sign)  # over p': (rows, j1, j0, m, s); output j = j1*R0 + j0
        v = v.reshape(rows, P, m, s)
        tw, table = table[: P * m].reshape(P, m), table[P * m :]
        v = (v * tw[None, :, :, None]).astype(np.complex64)
        x = np.ascontiguousarray(np.transpose(v, (0, 2, 1, 3))).reshape(rows, L)
        s *= P
    return x


@pytest.mark.parametrize("kind", [ct.FFT_REAL, ct.FFT_COMPLEX])
def test_engine_model_matches_float64(kind):
    """At every size: the pass model within 2e-7*N of numpy float64, the
    complex transform ordered and unordered, the real one through K1's
    split into packed planes, ordered and in the JAX unordered layout."""
    rng = np.random.default_rng(6)
    sizes = REAL_SIZES if kind == ct.FFT_REAL else COMPLEX_SIZES
    for n in sizes:
        plan = ct.cached_plan(n, kind)
        rows = 3
        if kind == ct.FFT_COMPLEX:
            z = (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
            want = np.fft.fft(z.astype(np.complex128), axis=-1)
            got = engine_model(z, plan)
            assert np.abs(got - want).max() <= 2e-7 * n, n
            perm = tables.cfft_unordered_perm(n)
            assert np.abs(got[:, perm] - want[:, perm]).max() <= 2e-7 * n, n
            continue
        x = rng.standard_normal((rows, n)).astype(np.float32)
        m = n // 2
        zz = engine_model(np.ascontiguousarray(x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64), plan)
        k = np.arange(1, m)
        zc = np.conj(zz[:, m - k])
        e, o = (zz[:, k] + zc) / 2, -0.5j * (zz[:, k] - zc)
        w = (plan.rfft_tw_re + 1j * plan.rfft_tw_im)[k]
        xk = e + w * o
        re = np.concatenate([(zz[:, :1].real + zz[:, :1].imag), xk.real], -1)
        im = np.concatenate([(zz[:, :1].real - zz[:, :1].imag), xk.imag], -1)
        spec = np.fft.rfft(x.astype(np.float64), axis=-1)
        want_re, want_im = spec[:, :m].real.copy(), spec[:, :m].imag.copy()
        want_im[:, 0] = spec[:, m].real
        for sel in (slice(None), tables.unordered_perm(n)):
            err = max(np.abs(re[:, sel] - want_re[:, sel]).max(), np.abs(im[:, sel] - want_im[:, sel]).max())
            assert err <= 2e-7 * n, n


@pytest.mark.parametrize("n,kind", [(384, ct.FFT_REAL), (4096, ct.FFT_COMPLEX), (13824, ct.FFT_COMPLEX)])
def test_pass_twiddles_are_float64_roots(n, kind):
    """Each pass's table holds W_L^(j*p*s) at [j*m + p], rounded once from
    float64; the real plan's unordered split table is the plan's split
    table in the unordered layout."""
    plan = ct.cached_plan(n, kind)
    L = row_passes.row_points(plan)
    table = row_passes.pass_twiddles(plan.radices, L)
    s, off = 1, 0
    for r0, r1 in row_passes.pass_plan(plan.radices):
        P = r0 * r1
        m = L // (P * s)
        j, p = np.meshgrid(np.arange(P), np.arange(m), indexing="ij")
        want = np.exp(-2j * np.pi * ((j * p * s) % L) / L)
        np.testing.assert_array_equal(table[off : off + P * m].reshape(P, m), want.astype(np.complex64))
        off, s = off + P * m, s * P
    assert off == table.size
    tw, split = row_passes.device_tables(n, kind, "cpu")
    assert torch.equal(tw, torch.from_numpy(table))
    if kind == ct.FFT_REAL:
        perm = tables.unordered_perm(n)
        np.testing.assert_array_equal(split.real.numpy(), plan.rfft_tw_re[perm])
        np.testing.assert_array_equal(split.imag.numpy(), plan.rfft_tw_im[perm])
    else:
        assert split is None


def test_geometry_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        row_passes.launch_geometry(ct.cached_plan(1 << 15, ct.FFT_COMPLEX), 1)  # 1 MB of shared memory
    with pytest.raises(ValueError):
        row_passes.launch_geometry(ct.cached_plan(200, ct.FFT_COMPLEX), 1)  # 200 % 16


# ---------------------------------------------------------------------------
# K2/K3 (and K2-db): the packed real inverse on the same engine
# ---------------------------------------------------------------------------


def irfft_model(pre, pim, plan, ordered: bool = True, b=None, scale: float = 1.0) -> np.ndarray:
    """K2 (``b`` None) or K3 (``b`` = (bre, bim), 1 or rows rows) on packed
    planes (rows, M) in position order, as row_fft.cuh computes it: the
    first exchange (K3: scale * A (.) B with the bin-0 patch-up
    re[0] = Ar*Br, im[0] = Ai*Bi, in float32) scatters position p to its
    bin (perm[p] unordered), slot 0 keeping DC in re and Nyquist in im;
    the first pass reads bin k merged from X[k] and conj X[M-k] with the
    plan's split twiddle w_k (stockham.cuh merge_bin; X[M] = Nyq at k=0);
    the SIGN = +1 passes; the store of 2 z as N real samples."""
    re, im = np.asarray(pre, np.float32), np.asarray(pim, np.float32)
    rows, M = re.shape
    if b is not None:
        br, bi = (np.asarray(t, np.float32) for t in b)
        pr, pi = re * br - im * bi, re * bi + im * br
        pr[:, 0], pi[:, 0] = re[:, 0] * br[:, 0], im[:, 0] * bi[:, 0]
        re, im = (pr * np.float32(scale)).astype(np.float32), (pi * np.float32(scale)).astype(np.float32)
    X = np.empty((rows, M), np.complex64)
    X[:, np.arange(M) if ordered else tables.unordered_perm(plan.n)] = re + 1j * im
    k = np.arange(M)
    xk = X.copy()
    xr = np.conj(X[:, (M - k) % M])
    xk[:, 0], xr[:, 0] = X[:, 0].real, X[:, 0].imag
    w = (plan.rfft_tw_re + 1j * plan.rfft_tw_im).astype(np.complex64)[None, :M]
    e = ((xk + xr) * np.float32(0.5)).astype(np.complex64)
    o = (np.conj(w) * ((xk - xr) * np.float32(0.5))).astype(np.complex64)
    z = (e + 1j * o).astype(np.complex64)
    zz = engine_model(z, plan, sign=1)
    out = np.empty((rows, 2 * M), np.float32)
    out[:, 0::2], out[:, 1::2] = 2 * zz.real, 2 * zz.imag
    return out


def _packed(x64: np.ndarray, ordered: bool, n: int):
    """float64 packed planes of real rows (Nyquist in im[0]), in position
    order, rounded to float32 as a kernel's input."""
    spec = np.fft.rfft(x64, axis=-1)
    m = n // 2
    re, im = spec[:, :m].real.copy(), spec[:, :m].imag.copy()
    im[:, 0] = spec[:, m].real
    sel = slice(None) if ordered else tables.unordered_perm(n)
    return re[:, sel].astype(np.float32), im[:, sel].astype(np.float32)


@pytest.mark.parametrize("n", REAL_SIZES)
def test_inverse_model_matches_float64(n):
    """At every size of K2/K3's domain, both orders: the inverse model
    within 2e-7*N of float64 (out / N against the rows whose spectra it
    was given), and K3's within 2e-7*N of the float64 circular
    convolution, with a 1-row (shared) B and a rows-row B."""
    rng = np.random.default_rng(n)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    rows = 3
    x = rng.standard_normal((rows, n)).astype(np.float32).astype(np.float64)
    h = (rng.standard_normal((rows, n)) / np.sqrt(n)).astype(np.float32).astype(np.float64)
    for ordered in (True, False):
        a = _packed(x, ordered, n)
        assert np.abs(irfft_model(*a, plan, ordered) / n - x).max() <= 2e-7 * n, (n, ordered)
        hb = _packed(h, ordered, n)
        for b_rows in (1, rows):
            b = (hb[0][:b_rows], hb[1][:b_rows])
            want = np.fft.irfft(np.fft.rfft(x) * np.fft.rfft(h[:b_rows]), n=n)
            got = irfft_model(*a, plan, ordered, b=b, scale=1.0 / n)
            assert np.abs(got - want).max() <= 2e-7 * n, (n, ordered, b_rows)


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n", [384, 4096])
@pytest.mark.parametrize("bin_", ["dc", "nyquist"])
def test_inverse_model_ends_of_the_merge(bin_, n, ordered):
    """One nonzero bin at each end of the merge, at an odd n1 (384 =
    3*128) and a power of two: DC alone gives the constant row, the
    Nyquist bin alone (im[0]) the alternating one, unscaled; the model
    within 2e-7*N of both, and the other bin's row fails."""
    plan = ct.cached_plan(n, ct.FFT_REAL)
    re = np.zeros((1, n // 2), np.float32)
    im = np.zeros_like(re)
    (re if bin_ == "dc" else im)[0, 0] = 0.75  # position 0 is bin 0 in both layouts
    got = irfft_model(re, im, plan, ordered)
    alt = 0.75 * (-1.0) ** np.arange(n)
    want, other = (np.full(n, 0.75), alt) if bin_ == "dc" else (alt, np.full(n, 0.75))
    assert np.abs(got[0] - want).max() <= 2e-7 * n
    assert np.abs(got[0] - other).max() > 2e-7 * n


@pytest.mark.parametrize("n", [384, 4096, 16384])
def test_inverse_model_matches_jax(n):
    """The JAX package's K2 and K3 (``_pallas_irfft_packed``,
    ``_pallas_irfft_conv``, interpret mode, as its own tests run them)
    against the inverse model on the same packed planes, both orders,
    a shared and a batched B: within 2e-7*N (K2 per sample, out / N;
    K3's scale 1/N leaves unit-scale rows)."""
    import jax.numpy as jnp

    from chowdsp_fft_tpu.ops import pallas_fft

    rng = np.random.default_rng(n + 1)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    rows = 3
    x = rng.standard_normal((rows, n))
    h = rng.standard_normal((rows, n)) / np.sqrt(n)
    for ordered in (True, False):
        a = _packed(x, ordered, n)
        want = np.asarray(pallas_fft._pallas_irfft_packed(*map(jnp.asarray, a), n, ordered))
        # Unscaled (N x): compare per sample, as test_torch_real_fft.py does.
        assert np.abs(irfft_model(*a, plan, ordered) / n - want / n).max() <= 2e-7 * n, (n, ordered)
        hb = _packed(h, ordered, n)
        for b_rows in (1, rows):
            b = (hb[0][:b_rows], hb[1][:b_rows])
            want = np.asarray(pallas_fft._pallas_irfft_conv(*map(jnp.asarray, (*a, *b)), n, ordered, 1.0 / n))
            got = irfft_model(*a, plan, ordered, b=b, scale=1.0 / n)
            assert np.abs(got - want).max() <= 2e-7 * n, (n, ordered, b_rows)


@pytest.mark.parametrize("n", REAL_SIZES)
def test_inverse_launches_take_the_row_geometry(n, monkeypatch):
    """K2, K3 and K2-db launch with launch_geometry's pass plan (the plan's
    stages fused in pairs), the pass twiddles and the plan's split table
    in bin order; the grid forms also with its rows per block, threads,
    shared bytes and grid, at every size, for 1, 7 and 1001 rows."""
    calls = []
    monkeypatch.setattr(hopper_fft, "launch", lambda kernel, entry, device, *args: calls.append((kernel, args)))
    plan = ct.cached_plan(n, ct.FFT_REAL)
    cpu = torch.device("cpu")
    tw, _ = row_passes.device_tables(n, ct.FFT_REAL, "cpu")
    split = plan.device_tables(cpu).split_tw
    cases = ((hopper_fft.K2, "k2_irfft_packed", 5, True), (hopper_fft.K3, "k3_convolve_irfft_packed", 9, True),
             (hopper_fft.K2_DB, "k2db_irfft_packed", 5, False))
    for rows in (1, 7, 1001):
        g = row_passes.launch_geometry(plan, rows)
        for ordered in (True, False):
            for kernel, entry, lead, grid in cases:
                calls.clear()
                hopper_fft._launch_rows(kernel, entry, plan, cpu, ordered, rows, *range(lead), position_split=False,
                                        grid=grid)
                (got_kernel, args), = calls
                assert got_kernel is kernel and args[:lead] == tuple(range(lead))
                passes_at, npasses, tw_ptr, split_ptr, perm = args[lead + 2 : lead + 7]
                assert npasses == len(g.passes)
                assert tuple((ctypes.c_int * (2 * npasses)).from_address(passes_at)) == g.flat_passes
                assert tuple((ctypes.c_int * len(plan.radices)).from_address(args[lead])) == plan.radices
                assert (tw_ptr, split_ptr) == (tw.data_ptr(), split.data_ptr())
                assert (perm is None) == ordered
                assert args[lead + 7 :] == (g.args if grid else ())


_ROW_WRAPPERS = (
    ("rfft_packed_kernel", lambda re, im, b, plan: hopper_fft.rfft_packed_kernel(b, plan, False), True, True),
    ("rfft_packed_joint_kernel", lambda re, im, b, plan: hopper_fft.rfft_packed_joint_kernel(b, plan, False),
     True, True),
    ("rfft_packed_joint_db_kernel",
     lambda re, im, b, plan: hopper_fft.rfft_packed_joint_db_kernel(b, plan, False), True, False),
    ("irfft_packed_kernel", lambda re, im, b, plan: hopper_fft.irfft_packed_kernel(re, im, plan, False),
     False, True),
    ("irfft_packed_db_kernel", lambda re, im, b, plan: hopper_fft.irfft_packed_db_kernel(re, im, plan, False),
     False, False),
    ("convolve_irfft_packed_kernel",
     lambda re, im, b, plan: hopper_fft.convolve_irfft_packed_kernel(re, im, re[:1], im[:1], 0.5, plan, False),
     False, True),
)


@pytest.mark.parametrize("name, call, position_split, grid", _ROW_WRAPPERS, ids=[w[0] for w in _ROW_WRAPPERS])
def test_row_wrappers_pick_split_order_and_grid(name, call, position_split, grid, monkeypatch):
    """Each wrapper of K1-K3 and their db forms tells the launcher which
    split table its kernel reads (K1's epilogue in position order, the
    inverse's merge in bin order) and whether to append the launch
    geometry (grid forms only). Driven on meta tensors, so only the
    wrapper's own logic runs."""
    calls = []
    monkeypatch.setattr(hopper_fft, "takes_plain", lambda *a: False)
    monkeypatch.setattr(hopper_fft, "_launch_rows", lambda *a, **kw: calls.append(kw))
    n, rows = 4096, 7
    plan = ct.cached_plan(n, ct.FFT_REAL)
    meta = torch.device("meta")
    re = torch.empty((rows, n // 2), device=meta)
    call(re, torch.empty_like(re), torch.empty((rows, n), device=meta), plan)
    assert calls == [{"position_split": position_split, "grid": grid}], name


def test_inverse_runs_the_row_engine():
    """K2, K3 and K2-db run row_fft.cuh's irfft_row (the row engine's
    passes, the merge in the first pass's reads); only K5 still reaches
    stockham.cuh's run_stages. K7a runs the column engine's passes
    (col_passes.cuh), its old stage body and tile rule gone."""
    for name in ("real_fft.cu", "pipelined_fft.cu"):
        src = (CSRC / name).read_text()
        assert "irfft_row<" in src and "run_stages" not in src
    row = (CSRC / "row_fft.cuh").read_text()
    assert "MergeIn{" in row and "run_stages" not in row
    callers = sorted(p.name for p in CSRC.glob("*.cu") if "run_stages<" in p.read_text())
    assert callers == ["small_fft.cu"]
    comp = (CSRC / "composite_fft.cu").read_text()
    k7a = comp[comp.index("rfft_col_passes_kernel("):comp.index("// K7b:")]
    assert "run_col_passes<-1, true>" in k7a and "run_col_passes_in_place<-1, true>" in k7a
    assert "RealColsIn in{" in k7a and "split_bin(" in k7a
    assert not re.search(r"\brfft_cols_kernel\b", comp) and "tile_shift" not in comp and "col_tile" not in comp
    assert "col_tile" not in (CSRC.parent / "ops" / "_cuda.py").read_text()
    assert "case 5: return reinterpret_cast<const void*>(rfft_col_passes_kernel<SHAPE>)" in comp
