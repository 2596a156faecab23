"""Port parity: the multichannel convolver (BASELINE config 4) against the
JAX model and numpy float64, on the same numpy inputs (test_models.py's
cases; the channel-sharded one is in test_torch_parallel.py, on a gloo
group). Tolerances are test_models.py's: 1e-3 offline
against float64 (and against the JAX model), 1e-4 streaming against
offline. A model built from the JAX model's spectra, and a stream state
carried across mid-way, keep matching JAX."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chowdsp_fft_tpu import models as jmodels
from chowdsp_fft_tpu_torch import convert, models

OFFLINE_ATOL = 1e-3
STREAM_ATOL = 1e-4


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def conv64(x: np.ndarray, ir: np.ndarray) -> np.ndarray:
    t = x.shape[-1]
    return np.stack([np.convolve(x[c].astype(np.float64), ir[c].astype(np.float64))[:t] for c in range(x.shape[0])])


@pytest.fixture(scope="module")
def conv_setup():
    rng = np.random.default_rng(4)
    ch, taps, t = 4, 700, 6144
    ir = (rng.standard_normal((ch, taps)) / 32).astype(np.float32)
    x = rng.standard_normal((ch, t)).astype(np.float32)
    return ir, x, conv64(x, ir)


def test_config_matches_jax():
    assert [f.name for f in dataclasses.fields(models.ConvolverConfig)] == \
        [f.name for f in dataclasses.fields(jmodels.ConvolverConfig)]
    assert models.ConvolverConfig() == models.ConvolverConfig(**dataclasses.asdict(jmodels.ConvolverConfig()))


@pytest.mark.parametrize("block", [512, 128])
def test_convolver_offline_matches_numpy_and_jax(conv_setup, block):
    """Block 512 runs K1/K2 (N = 1024), block 128 the small-N DFT (N = 256)."""
    ir, x, ref = conv_setup
    cfg = models.ConvolverConfig(channels=4, block=block)
    conv = models.MultichannelConvolver(ir, cfg, device="cpu")
    y = np_(conv.apply(x))
    assert y.shape == x.shape
    assert np.abs(y - ref).max() < OFFLINE_ATOL
    jconv = jmodels.MultichannelConvolver(jnp.asarray(ir), jmodels.ConvolverConfig(channels=4, block=block))
    assert np.abs(y - np.asarray(jconv.apply(jnp.asarray(x)))).max() < OFFLINE_ATOL
    assert torch.equal(conv(torch.from_numpy(x)), conv.apply(x))


def test_convolver_streaming_matches_offline(conv_setup):
    ir, x, _ = conv_setup
    cfg = models.ConvolverConfig(channels=4, block=512)
    conv = models.MultichannelConvolver(ir, cfg, device="cpu")
    off = np_(conv.apply(x))
    st = conv.init_state()
    outs = []
    for i in range(x.shape[1] // cfg.block):
        st, y = conv.step(st, x[:, i * cfg.block : (i + 1) * cfg.block])
        outs.append(np_(y))
    got = np.concatenate(outs, axis=1)
    assert np.abs(got - off[:, : got.shape[1]]).max() < STREAM_ATOL


def test_convolver_broadcast_ir():
    rng = np.random.default_rng(5)
    taps, t = 256, 2048
    ir = (rng.standard_normal(taps) / 16).astype(np.float32)
    x = rng.standard_normal((2, t)).astype(np.float32)
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=2, block=256), device="cpu")
    assert tuple(conv.h_re.shape[:1]) == (2,)
    y = np_(conv.apply(torch.from_numpy(x)))
    assert np.abs(y - conv64(x, np.stack([ir, ir]))).max() < OFFLINE_ATOL


def test_convolver_checks_channels():
    with pytest.raises(ValueError, match="channels"):
        models.MultichannelConvolver(np.zeros((3, 64), np.float32), models.ConvolverConfig(channels=4, block=64),
                                     device="cpu")


def test_convolver_spectra_are_buffers():
    conv = models.MultichannelConvolver(np.ones((2, 300), np.float32) / 300,
                                        models.ConvolverConfig(channels=2, block=256), device="cpu")
    assert set(dict(conv.named_buffers())) == {"h_re", "h_im"}
    assert conv.h_re.shape == (2, 2, 256) and conv.to(torch.float32).h_re.device.type == "cpu"


@pytest.mark.parametrize("block", [512, 128])
def test_convolver_from_jax_spectra_and_state(conv_setup, block):
    """convert.convolver_from_numpy on the JAX model's spectra reproduces
    its offline output, and a JAX stream state carried across with
    fir_state_from_numpy continues as JAX's does."""
    ir, x, _ = conv_setup
    jcfg = jmodels.ConvolverConfig(channels=4, block=block)
    jconv = jmodels.MultichannelConvolver(jnp.asarray(ir), jcfg)
    conv = convert.convolver_from_numpy(np.asarray(jconv.fir.h_re), np.asarray(jconv.fir.h_im), jcfg, device="cpu")
    assert isinstance(conv, models.MultichannelConvolver) and conv.config == models.ConvolverConfig(channels=4, block=block)
    assert np.abs(np_(conv.apply(x)) - np.asarray(jconv.apply(jnp.asarray(x)))).max() < OFFLINE_ATOL

    jstate = jconv.init_state()
    steps = 3
    for i in range(steps):
        jstate, _ = jconv.step(jstate, jnp.asarray(x[:, i * block : (i + 1) * block]))
    state = convert.fir_state_from_numpy({k: np.asarray(v) for k, v in jstate.items()}, conv.fir)
    frame = x[:, steps * block : (steps + 1) * block]
    _, jy = jconv.step(jstate, jnp.asarray(frame))
    _, y = conv.step(state, frame)
    assert np.abs(np_(y) - np.asarray(jy)).max() < STREAM_ATOL

    # The port's own state after the same steps is the carried state.
    own = conv.init_state()
    for i in range(steps):
        own, _ = conv.step(own, x[:, i * block : (i + 1) * block])
    for key in ("fdl_re", "fdl_im", "prev"):
        assert np.abs(np_(own[key]) - np_(state[key])).max() < STREAM_ATOL


def test_convolver_step_survives_a_refilled_frame(conv_setup):
    """``step`` on one frame tensor refilled in place between calls gives
    what fresh frames give, and what the JAX model gives on the same
    numpy frames."""
    ir, x, _ = conv_setup
    block = 512
    cfg = models.ConvolverConfig(channels=4, block=block)
    conv = models.MultichannelConvolver(ir, cfg, device="cpu")
    jconv = jmodels.MultichannelConvolver(jnp.asarray(ir), jmodels.ConvolverConfig(channels=4, block=block))
    fresh_st, reused_st, jst = conv.init_state(), conv.init_state(), jconv.init_state()
    buf = torch.empty((4, block))
    for i in range(4):
        frame = np.ascontiguousarray(x[:, i * block : (i + 1) * block])
        fresh_st, fresh_y = conv.step(fresh_st, torch.from_numpy(frame.copy()))
        buf.copy_(torch.from_numpy(frame))
        reused_st, reused_y = conv.step(reused_st, buf)
        jst, jy = jconv.step(jst, jnp.asarray(frame))
        assert torch.equal(reused_y, fresh_y)
        assert np.abs(np_(reused_y) - np.asarray(jy)).max() < STREAM_ATOL
    buf.fill_(1e3)
    assert torch.equal(reused_st["prev"], fresh_st["prev"])


def test_convolver_from_spectra_keeps_copies(conv_setup):
    """A convolver built from spectra owns its buffers: writing to the
    caller's tensors afterwards changes nothing."""
    ir, x, ref = conv_setup
    cfg = models.ConvolverConfig(channels=4, block=512)
    src = models.MultichannelConvolver(ir, cfg, device="cpu")
    h_re, h_im = src.h_re.clone(), src.h_im.clone()
    conv = models.MultichannelConvolver.from_spectra(h_re, h_im, cfg)
    h_re.zero_()
    h_im.fill_(3.0)
    y = np_(conv.apply(x))
    assert np.abs(y - ref).max() < OFFLINE_ATOL
    assert torch.equal(conv.apply(x), src.apply(x))
