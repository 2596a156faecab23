"""Port parity: the overlap-save stream layer against the JAX package (its
Pallas engine in interpret mode on the CPU) and against
scipy.signal.lfilter in float64, on the same numpy streams. Tolerances are
tests/test_stream.py's: atol 5e-4 for fir_filter_ols, 1e-3 for the
partitioned filter. A stream begun in JAX and carried into the port
through ``convert`` mid-way keeps matching JAX."""

import numpy as np
import pytest
import scipy.signal as sig
import torch

from chowdsp_fft_tpu import stream as jstream
from chowdsp_fft_tpu_torch import convert
from chowdsp_fft_tpu_torch import stream as pstream
from chowdsp_fft_tpu_torch.ops import hopper_fft

OLS_ATOL = 5e-4
PFIR_ATOL = 1e-3


def lfilter_ref(h, x):
    return sig.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64), axis=-1)


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("taps,t", [(33, 4000), (129, 10000), (4096, 20000)])
def test_fir_filter_ols_matches_jax_and_lfilter(taps, t):
    rng = np.random.default_rng(taps)
    x = rng.standard_normal((2, t)).astype(np.float32)
    h = (rng.standard_normal(taps) / np.sqrt(taps)).astype(np.float32)
    y = np_(pstream.fir_filter_ols(torch.from_numpy(x), torch.from_numpy(h)))
    assert y.shape == x.shape
    np.testing.assert_allclose(y, np.asarray(jstream.fir_filter_ols(x, h)), atol=OLS_ATOL, rtol=0)
    np.testing.assert_allclose(y, lfilter_ref(h, x), atol=OLS_ATOL, rtol=0)


def test_fir_filter_ols_per_stream_filters():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    h = (rng.standard_normal((2, 65)) / 8).astype(np.float32)
    y = np_(pstream.fir_filter_ols(torch.from_numpy(x), torch.from_numpy(h), block=512))
    np.testing.assert_allclose(y, np.asarray(jstream.fir_filter_ols(x, h, block=512)), atol=OLS_ATOL, rtol=0)
    ref = np.stack([lfilter_ref(h[i], x[i]) for i in range(2)])
    np.testing.assert_allclose(y, ref, atol=OLS_ATOL, rtol=0)


@pytest.fixture(scope="module")
def pfir_case():
    rng = np.random.default_rng(11)
    taps, block, t = 2000, 512, 8192
    x = rng.standard_normal((2, t)).astype(np.float32)
    h = (rng.standard_normal(taps) / np.sqrt(taps)).astype(np.float32)
    jfir = jstream.PartitionedFIR(h, block=block)
    return {
        "x": x, "h": h, "block": block,
        "ref": lfilter_ref(h, x),
        "jax": np.asarray(jfir.apply_offline(x)),
    }


def test_partitioned_apply_offline(pfir_case):
    c = pfir_case
    fir = pstream.PartitionedFIR(torch.from_numpy(c["h"]), block=c["block"])
    y = np_(fir.apply_offline(torch.from_numpy(c["x"])))
    np.testing.assert_allclose(y, c["jax"], atol=PFIR_ATOL, rtol=0)
    np.testing.assert_allclose(y, c["ref"], atol=PFIR_ATOL, rtol=0)


@pytest.mark.parametrize("chunk", [1, 4])
def test_partitioned_fir_apply_streaming(pfir_case, chunk):
    """partitioned_fir_apply(streaming=True): chunk=1 steps through step(),
    chunk=4 through step_k()."""
    c = pfir_case
    y = np_(pstream.partitioned_fir_apply(
        torch.from_numpy(c["x"]), torch.from_numpy(c["h"]), block=c["block"],
        streaming=True, chunk=chunk,
    ))
    want = np.asarray(jstream.partitioned_fir_apply(
        c["x"], c["h"], block=c["block"], streaming=True, chunk=chunk
    ))
    np.testing.assert_allclose(y, want, atol=PFIR_ATOL, rtol=0)
    np.testing.assert_allclose(y, c["ref"], atol=PFIR_ATOL, rtol=0)


def test_step_and_step_k_match_jax(pfir_case):
    """A few blocks through step() and one K=3 step_k(), each against the
    JAX method on the same state."""
    c = pfir_case
    block = c["block"]
    jfir = jstream.PartitionedFIR(c["h"], block=block)
    pfir = pstream.PartitionedFIR(torch.from_numpy(c["h"]), block=block)
    jst, pst = jfir.init_state((2,)), pfir.init_state((2,))
    outs = []
    for i in range(2):
        xb = np.ascontiguousarray(c["x"][:, i * block : (i + 1) * block])
        jst, jy = jfir.step(jst, xb)
        pst, py = pfir.step(pst, torch.from_numpy(xb))
        np.testing.assert_allclose(np_(py), np.asarray(jy), atol=PFIR_ATOL, rtol=0)
        outs.append(np_(py))
    xk = np.ascontiguousarray(c["x"][:, 2 * block : 5 * block]).reshape(2, 3, block)
    jst, jy = jfir.step_k(jst, xk)
    pst, py = pfir.step_k(pst, torch.from_numpy(xk))
    np.testing.assert_allclose(np_(py), np.asarray(jy), atol=PFIR_ATOL, rtol=0)
    outs.append(np_(py).reshape(2, -1))
    y = np.concatenate(outs, axis=-1)
    np.testing.assert_allclose(y, c["ref"][:, : 5 * block], atol=PFIR_ATOL, rtol=0)
    for key in ("fdl_re", "fdl_im", "prev"):
        assert pst[key].shape == tuple(np.asarray(jst[key]).shape)


@pytest.mark.parametrize("engine", ["auto", "stockham"])
def test_stream_moves_from_jax_to_port(engine):
    """Begin a stream in JAX, carry its filter spectra and state into the
    port through convert mid-way, and continue: the port keeps matching
    JAX (whose unordered spectra and FDL the port reads unchanged on the
    Hopper engine and reorders for the Stockham one)."""
    rng = np.random.default_rng(5)
    block, taps, nblocks, split = 512, 1500, 6, 3
    x = rng.standard_normal((2, nblocks * block)).astype(np.float32)
    h = (rng.standard_normal(taps) / np.sqrt(taps)).astype(np.float32)
    blocks = [np.ascontiguousarray(x[:, i * block : (i + 1) * block]) for i in range(nblocks)]

    jfir = jstream.PartitionedFIR(h, block=block)
    jst = jfir.init_state((2,))
    for b in blocks[:split]:
        jst, _ = jfir.step(jst, b)

    pfir = convert.partitioned_fir_from_numpy(
        np.asarray(jfir.h_re), np.asarray(jfir.h_im), block, engine=engine, device="cpu"
    )
    pst = convert.fir_state_from_numpy({k: np.asarray(v) for k, v in jst.items()}, pfir)
    jy, py = [], []
    for b in blocks[split:]:
        jst, y = jfir.step(jst, b)
        jy.append(np.asarray(y))
        pst, y = pfir.step(pst, torch.from_numpy(b))
        py.append(np_(y))
    np.testing.assert_allclose(np.concatenate(py, -1), np.concatenate(jy, -1), atol=PFIR_ATOL, rtol=0)
    ref = lfilter_ref(h, x)[:, split * block :]
    np.testing.assert_allclose(np.concatenate(py, -1), ref, atol=PFIR_ATOL, rtol=0)
    if engine == "auto":
        # Same layout on both sides: the converted FDL is JAX's, unchanged.
        assert hopper_fft.supports_plan(pfir.plan)
        np.testing.assert_allclose(np_(pst["fdl_re"]), np.asarray(jst["fdl_re"]), atol=PFIR_ATOL, rtol=0)


def test_convert_rejects_bad_spectra():
    with pytest.raises(ValueError):
        convert.partitioned_fir_from_numpy(np.zeros((2, 100), np.float32), np.zeros((2, 100), np.float32), 512,
                                           device="cpu")


@pytest.mark.parametrize("method", ["step", "step_k"])
def test_stream_state_survives_a_refilled_block(pfir_case, method):
    """A streaming caller that refills one input tensor in place between
    calls gets what fresh tensors give, and what JAX gives on the same
    numpy data: the state keeps a copy of the last block, not a view of
    the caller's tensor."""
    c = pfir_case
    block, k = c["block"], (1 if method == "step" else 2)
    x = c["x"][:, : 4 * k * block]
    chunks = [np.ascontiguousarray(x[:, i * k * block : (i + 1) * k * block]).reshape(2, k, block)
              for i in range(4)]
    if method == "step":
        chunks = [ch[:, 0, :] for ch in chunks]
    jfir = jstream.PartitionedFIR(c["h"], block=block)
    pfir = pstream.PartitionedFIR(torch.from_numpy(c["h"]), block=block)
    jst, fresh_st, reused_st = jfir.init_state((2,)), pfir.init_state((2,)), pfir.init_state((2,))
    buf = torch.empty(chunks[0].shape)
    for ch in chunks:
        jst, jy = getattr(jfir, method)(jst, ch)
        fresh_st, fresh_y = getattr(pfir, method)(fresh_st, torch.from_numpy(ch.copy()))
        buf.copy_(torch.from_numpy(ch))
        reused_st, reused_y = getattr(pfir, method)(reused_st, buf)
        assert torch.equal(reused_y, fresh_y)
        np.testing.assert_allclose(np_(reused_y), np.asarray(jy), atol=PFIR_ATOL, rtol=0)
    buf.fill_(1e3)  # a refill after the last call leaves the state alone
    for key in ("fdl_re", "fdl_im", "prev"):
        assert torch.equal(reused_st[key], fresh_st[key])
    y = np_(pfir.apply_offline(torch.from_numpy(np.ascontiguousarray(x))))
    np.testing.assert_allclose(np_(reused_y).reshape(2, -1), y[:, -k * block :], atol=PFIR_ATOL, rtol=0)


def test_from_spectra_keeps_copies(pfir_case):
    """A filter built from spectra is not changed by a later write to the
    caller's tensors, and keeps matching JAX."""
    c = pfir_case
    block = c["block"]
    jfir = jstream.PartitionedFIR(c["h"], block=block)
    h_re = torch.from_numpy(np.array(jfir.h_re))
    h_im = torch.from_numpy(np.array(jfir.h_im))
    fir = pstream.PartitionedFIR.from_spectra(h_re, h_im, block)
    h_re.fill_(7.0)
    h_im.zero_()
    assert not torch.equal(fir.h_re, h_re)
    y = np_(fir.apply_offline(torch.from_numpy(c["x"])))
    np.testing.assert_allclose(y, c["jax"], atol=PFIR_ATOL, rtol=0)
    np.testing.assert_allclose(y, c["ref"], atol=PFIR_ATOL, rtol=0)
