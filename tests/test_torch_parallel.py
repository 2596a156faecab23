"""Port parity: the parallel layer (``chowdsp_fft_tpu_torch/parallel``, the
convolver's and the SDR chain's sharded forms) against the JAX package,
case for case with tests/test_parallel.py and test_models.py's
``test_convolver_channel_sharded``.

Two kinds of case:

- pure helpers, in this process: the split, the bin orders and the
  chunk row maps against JAX's at every device count its tests use (up
  to 8), the rank layout of the multi-host mesh, ``init_multihost``
  without a group, the halo weak-scaling model;
- collectives, on CPU gloo groups of 1, 2, 3 and 4 ranks: one process a rank
  runs tests/torch_parallel_cases.py, each group spawned once for the
  module (``file://`` rendezvous under the test's temporary directory)
  and started before the JAX side runs here, on its own virtual mesh of
  4 devices (conftest's 8), on the same numpy inputs. The ranks hand
  back gathered numpy results.

Tolerances are JAX's: 5e-4 and 2e-3 for the filters (against lfilter and
against JAX's sharded filters), 1e-4 for the SDR chain, 2e-7*N for the
transforms, 4e-6 and 1e-4 of the peak for the circular convolutions,
1e-3 for the convolver. Where JAX's interpret-mode Pallas would cost tens
of seconds for one more sharded call (smooth N, the odd-A trap, the
chunked orders), the port is held to float64 at the same tolerance and
JAX's split and orders are compared exactly. The distributed spectra
are compared in natural bin order, each package's through its own
``spectrum_order``: the two orders differ by design where a factor lies
above K4's 13824 (``_engine_perm``).
"""

import functools
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

import chowdsp_fft_tpu as cf
from chowdsp_fft_tpu import models as jmodels
from chowdsp_fft_tpu import parallel as jparallel
from chowdsp_fft_tpu.parallel import dist_fft as jdist
from chowdsp_fft_tpu.utils import roofline as jroof
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import models, parallel, stream
from chowdsp_fft_tpu_torch.ops import hopper_cfft, tables
from chowdsp_fft_tpu_torch.parallel import dist_fft, mesh as pmesh
from chowdsp_fft_tpu_torch.utils import roofline as roof

import torch_parallel_cases as cases

REPO = pathlib.Path(__file__).resolve().parents[1]
N = cases.N_FFT
TOL = 2e-7 * N
JAX_D = 4  # the JAX side's virtual mesh


# ---------------------------------------------------------------------------
# The gloo groups
# ---------------------------------------------------------------------------


class GlooGroup:
    """``world`` rank processes running every case of their group size."""

    TIMEOUT_S = 300

    def __init__(self, world: int, root: pathlib.Path):
        self.world, self.root = world, root
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
        script = pathlib.Path(cases.__file__)
        self.procs = []
        for rank in range(world):
            log = open(root / f"rank{rank}.log", "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, str(script), str(rank), str(world), str(root / "store"), str(root)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO,
            ))
            log.close()
        self._done = False

    def _wait(self):
        if self._done:
            return
        for rank, p in enumerate(self.procs):
            try:
                rc = p.wait(timeout=self.TIMEOUT_S)
            except subprocess.TimeoutExpired:
                self.close()
                pytest.fail(f"gloo group of {self.world}: rank {rank} did not finish in {self.TIMEOUT_S} s")
            assert rc == 0, f"rank {rank} of {self.world} exited {rc}:\n" + (self.root / f"rank{rank}.log").read_text()[-4000:]
        self._done = True

    def case(self, name: str) -> dict:
        self._wait()
        errs = sorted(self.root.glob(f"{name}.err*"))
        if errs:
            pytest.fail(f"case {name} on {self.world} ranks raised:\n" + errs[0].read_text())
        with np.load(self.root / f"{name}.npz") as f:
            return {k: f[k] for k in f.files}

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    groups = {w: GlooGroup(w, tmp_path_factory.mktemp(f"gloo{w}")) for w in cases.GROUPS}
    yield groups
    for g in groups.values():
        g.close()


# ---------------------------------------------------------------------------
# The JAX side, once per input (its interpret-mode Pallas is the cost here)
# ---------------------------------------------------------------------------


@functools.cache
def jmesh(d: int = JAX_D):
    return jparallel.dsp_mesh(d, axis=jparallel.TIME_AXIS)


@functools.cache
def jax_filter(case: str):
    i = cases.inputs(case)
    x, h = jnp.asarray(i["x"]), jnp.asarray(i["h"])
    if case == "pfir":
        return np.asarray(jparallel.sharded_partitioned_fir(x, h, jmesh(), block=512))
    return np.asarray(jparallel.sharded_fir_ols(x, h, jmesh()))


def natural(got: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """A distributed spectrum in natural bin order (perm[p] = bin at p)."""
    out = np.zeros_like(got)
    out[..., perm] = got
    return out


@functools.cache
def jax_fft():
    i = cases.inputs("fft")
    re, im = jdist.sharded_fft_planes(jnp.asarray(i["re"]), jnp.asarray(i["im"]), jmesh())
    back = jdist.sharded_ifft_planes(re, im, jmesh())
    spec = natural(np.asarray(re) + 1j * np.asarray(im), jdist.spectrum_order(N, JAX_D))
    return spec, np.asarray(back[0]) + 1j * np.asarray(back[1])


def rnatural(got: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """A distributed packed real spectrum's bins at their full-spectrum
    index (the padding rows dropped)."""
    out = np.zeros((*got.shape[:-1], N), got.dtype)
    valid = perm >= 0
    out[..., perm[valid]] = got[..., valid]
    return out


@functools.cache
def jax_rfft():
    x = jnp.asarray(cases.inputs("rfft")["re"])
    re, im = jdist.sharded_rfft_planes(x, jmesh())
    back = np.asarray(jdist.sharded_irfft_planes(re, im, jmesh(), N))
    return rnatural(np.asarray(re) + 1j * np.asarray(im), jdist.rspectrum_order(N, JAX_D)), back


@functools.cache
def jax_convolve():
    i = cases.inputs("convolve")
    real = np.asarray(jdist.sharded_rfft_convolve(jnp.asarray(i["x"]), jnp.asarray(i["h"]), jmesh()))
    cre, cim = jdist.sharded_fft_convolve(*(jnp.asarray(v) for v in (i["x"][0], i["x"][1], i["hr"], i["hi"])),
                                          jmesh())
    return real, np.asarray(cre) + 1j * np.asarray(cim)


@functools.cache
def jax_models():
    """JAX's sharded SDR chain, channel-sharded convolver and sharded rfft."""
    jchain = jmodels.SDRChain(jmodels.SDRChainConfig(**cases.SDR))
    with jmesh():
        sdr = np.asarray(jchain.sharded_step(jmesh())(jnp.asarray(cases.inputs("sdr")["iq"])))
    i = cases.inputs("convolver")
    jconv = jmodels.MultichannelConvolver(i["ir"], jmodels.ConvolverConfig(**cases.CONV))
    conv = np.asarray(jconv.channel_sharded_apply(jparallel.dsp_mesh(JAX_D, axis=jparallel.CHANNEL_AXIS))(i["x"]))
    xs = jparallel.shard_channels(jnp.asarray(cases.inputs("channels")["x"]), jmesh(), axis_name=jparallel.TIME_AXIS)
    return {"sdr": sdr, "convolver": conv, "channels": np.asarray(cf.rfft(xs))}


def fft64(z):
    return np.fft.fft(np.asarray(z, np.complex128), axis=-1)


def lfilter_ref(h, x):
    return sig.lfilter(np.asarray(h, np.float64), [1.0], np.asarray(x, np.float64), axis=-1)


def err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# ---------------------------------------------------------------------------
# Sharded streams (halo exchange)
# ---------------------------------------------------------------------------

WORLDS = [2, 4]


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_fir_ols_matches_single_device(gloo, d):
    r = gloo[d].case("fir")
    i = cases.inputs("fir")
    assert err(r["y"], lfilter_ref(i["h"], i["x"])) < 5e-4
    assert err(r["y"], jax_filter("fir")) < 5e-4
    # a DTensor sharded along the time dim, each rank holding T/D samples
    assert r["placement"].tolist() == [1, 0, i["x"].shape[-1] // d]


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_fir_ols_batched_channels(gloo, d):
    r = gloo[d].case("fir_batched")
    i = cases.inputs("fir_batched")
    assert err(r["y"], lfilter_ref(i["h"], i["x"])) < 5e-4
    assert err(r["y"], jax_filter("fir_batched")) < 5e-4
    np.testing.assert_array_equal(r["y_dtensor_in"], r["y"])  # a sharded DTensor in: the same result
    assert r["placement"].tolist() == [1, 1, i["x"].shape[-1] // d]


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_partitioned_fir_long_filter(gloo, d):
    r = gloo[d].case("pfir")
    i = cases.inputs("pfir")
    assert err(r["y"], lfilter_ref(i["h"], i["x"])) < 2e-3
    assert err(r["y"], jax_filter("pfir")) < 2e-3


@pytest.mark.parametrize("d", WORLDS)
def test_halo_exchange_boundary_exactness(gloo, d):
    """The first taps-1 outputs of every shard depend on the neighbour's
    tail; and the hop itself hands rank i rank i-1's last samples, zeros
    to rank 0."""
    y = gloo[d].case("fir")["y"]
    i = cases.inputs("fir")
    ref, jy, taps, t_loc = lfilter_ref(i["h"], i["x"]), jax_filter("fir"), i["h"].shape[-1], i["x"].shape[-1] // d
    for k in range(1, d):
        seg = slice(k * t_loc, k * t_loc + taps - 1)
        assert err(y[seg], ref[seg]) < 5e-4 and err(y[seg], jy[seg]) < 5e-4
    ext = gloo[d].case("guards")["ext"]
    x = np.arange(d * 64, dtype=np.float32).reshape(d, 64)
    np.testing.assert_array_equal(ext[:, 5:], x)
    np.testing.assert_array_equal(ext[0, :5], 0)
    for k in range(1, d):
        np.testing.assert_array_equal(ext[k, :5], x[k - 1, -5:])


@pytest.mark.parametrize("d", WORLDS)
def test_shard_channels_placement(gloo, d):
    r = gloo[d].case("channels")
    x = cases.inputs("channels")["x"]
    assert r["placement"].tolist() == [1, 0, 256]  # sharded along dim 0, whole rows a rank
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert err(r["spec"], ref) < 2e-7 * 256
    assert err(r["spec"], jax_models()["channels"]) < 2e-7 * 256


def test_sdr_chain_single_device():
    cfg = models.SDRChainConfig(channels=16, decimation=2, fm_gain=1.0)
    chain = models.SDRChain(cfg, device="cpu")
    t = 16 * 2 * 256 * 4
    rng = np.random.default_rng(11)
    iq = (rng.standard_normal(t) + 1j * rng.standard_normal(t)).astype(np.complex64)
    audio = chain(torch.from_numpy(iq)).numpy()
    assert audio.shape == (16, 256) and np.all(np.isfinite(audio))


@pytest.mark.parametrize("d", WORLDS)
def test_sdr_chain_sharded_matches_single(gloo, d):
    r = gloo[d].case("sdr")
    assert err(r["sharded"], r["single"]) < 1e-4
    assert r["placement"].tolist() == [1, 0, r["single"].shape[-1]]  # whole channels a rank
    assert err(r["sharded"], jax_models()["sdr"]) < 1e-4


@pytest.mark.parametrize("d", WORLDS)
def test_sdr_chain_recovers_fm_tone(gloo, d):
    """An FM tone in channel 5 of a 16-channel bank, through the sharded
    chain: channel 5's audio peaks at the message frequency."""
    a = gloo[d].case("sdr")["tone"][cases.TONE["channel"]][32:]  # drop the filter transient
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(a.size)))
    t = cases.TONE
    assert abs(spec.argmax() - t["msg_f"] * t["decimation"] * t["channels"] * t["audio_decimation"] * a.size) <= 2


@pytest.mark.parametrize("d", WORLDS)
def test_halo_exchange_guards(gloo, d):
    """halo 0 is a no-op; a halo beyond the shard and a zero halo handed
    to the tail hop raise."""
    r = gloo[d].case("guards")
    x = np.arange(d * 64, dtype=np.float32)
    np.testing.assert_allclose(r["y"], x, rtol=1e-5, atol=1e-3)
    assert "halo" in str(r["big"]) and "halo" in str(r["zero"])
    assert bool(r["halo0_is_input"])


@pytest.mark.parametrize("d", WORLDS)
def test_halo_overlap_structure(gloo, d):
    """JAX asserts on the jaxpr that the halo collective and the main
    filter share no dataflow edge. Here a spy records the order: the hop
    is posted before the main filter runs on the bare shard, waited on
    after it, and the only work after the wait is the boundary
    correction on 2*halo samples (halo = 256)."""
    events = gloo[d].case("overlap_order")["events"].tolist()
    assert events == ["post", "filter:16384", "wait", "filter:512"]


@pytest.mark.parametrize("d", WORLDS)
def test_dsp_mesh_rejects_too_many_devices(gloo, d):
    r = gloo[d].case("mesh")
    assert "devices" in str(r["too_many"]) and "devices" in str(r["too_many_2d"])
    assert r["names_1d"].tolist() == ["time"] and str(r["device_type"]) == "cpu"
    assert r["names_2d"].tolist() == ["chan", "time"] and r["shape_2d"].tolist() == [1, d]


# ---------------------------------------------------------------------------
# The distributed FFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_fft_roundtrip_and_differential(gloo, d):
    r = gloo[d].case("fft")
    i = cases.inputs("fft")
    z = i["re"] + 1j * i["im"]
    perm = dist_fft.spectrum_order(N, d)
    got = r["re"] + 1j * r["im"]
    assert err(got, fft64(z)[..., perm]) < TOL
    assert err(r["un_re"] + 1j * r["un_im"], got[0]) < TOL  # unbatched: the same row
    jspec, jback = jax_fft()
    assert err(natural(got, perm), jspec) < TOL
    back = (r["back_re"] + 1j * r["back_im"]) / N
    assert err(back, z) < TOL and err(back, jback / N) < TOL
    assert r["placement"].tolist() == [1, 1, N // d]


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_fft_smooth_n(gloo, d):
    """A {2,3,5}-smooth N (98304 = 384 * 256): the split is JAX's, the
    complex and real transforms hold to float64 and round-trip."""
    n = cases.N_SMOOTH
    a, c = dist_fft._dist_split(n, d)
    assert (a, c) == jdist._dist_split(n, d) and a % d == 0 and c % d == 0
    r = gloo[d].case("smooth")
    i = cases.inputs("smooth")
    z = i["re"] + 1j * i["im"]
    got = r["re"] + 1j * r["im"]
    assert err(got, fft64(z)[dist_fft.spectrum_order(n, d)]) < 2e-7 * n
    assert err((r["back_re"] + 1j * r["back_im"]) / n, z) < 2e-7 * n
    assert err(r["xback"] / n, i["x"]) < 2e-7 * n


@pytest.mark.parametrize("d", WORLDS)
def test_dist_fft_pipeline_chunks(gloo, d):
    """pipeline_chunks splits the batch into independent chains: the same
    spectra, twice the all_to_all calls (counted on the transpose
    helper), and an unbatched input refuses it."""
    r = gloo[d].case("pipeline_chunks")
    assert err(r["r1"], r["r2"]) < TOL and err(r["i1"], r["i2"]) < TOL
    assert err(r["back"] / N, cases.inputs("rfft")["re"]) < TOL
    c1, c2 = r["calls"].tolist()
    assert c1 == 2 and c2 == 2 * c1  # the real forward: two transposes, one a chunk
    assert "leading batch axis" in str(r["unbatched"])
    assert err(r["cr1"], r["cr2"]) < TOL and err(r["ci1"], r["ci2"]) < TOL


@pytest.mark.parametrize("d", WORLDS)
def test_dist_fft_transform_chunks(gloo, d, g=2):
    """transform_chunks slabs the second all_to_all: the stored order is
    spectrum_order(n, D, g) (not the unchunked one), the matching inverse
    undoes it, and the forward makes 1 + g all_to_all calls (one call
    carries both planes; JAX's count is 2 * (1 + g), one a plane)."""
    r = gloo[d].case("transform_chunks")
    i = cases.inputs("fft")
    z = i["re"][0] + 1j * i["im"][0]
    perm = dist_fft.spectrum_order(N, d, transform_chunks=g)
    assert not np.array_equal(perm, dist_fft.spectrum_order(N, d))
    assert err(r["re"] + 1j * r["im"], fft64(z)[perm]) < TOL
    assert err((r["back_re"] + 1j * r["back_im"]) / N, z) < TOL
    x = cases.inputs("rfft")["re"]
    rperm = dist_fft.rspectrum_order(N, d, transform_chunks=g)
    valid = rperm >= 0
    got = r["rre"] + 1j * r["rim"]
    assert err(got[:, valid], fft64(x)[:, rperm[valid]]) < TOL and not got[:, ~valid].any()
    assert err(r["xback"] / N, x) < TOL
    assert int(r["calls"]) == 1 + g
    assert "must divide" in str(r["bad"])


def test_dist_split_real_requires_even_a(gloo):
    """N=155520 over 3 devices balances to an odd A = 405, which the real
    transform's packed rows would silently corrupt: real=True skips it.
    The split is JAX's; on a 3-rank group the real transform holds to
    float64 and round-trips."""
    n, d = cases.N_ODD_TRAP, 3
    assert dist_fft._dist_split(n, d)[0] % 2 == 1
    a, c = dist_fft._dist_split(n, d, real=True)
    assert a % 2 == 0 and a * c == n and a % d == 0 and c % d == 0
    assert (a, c) == jdist._dist_split(n, d, real=True)
    r = gloo[d].case("odd_trap")
    x = cases.inputs("odd_trap")["x"]
    perm = dist_fft.rspectrum_order(n, d)
    valid = perm >= 0
    got = r["re"] + 1j * r["im"]
    assert err(got[:, valid], fft64(x)[:, perm[valid]]) < 2e-7 * n
    assert err(r["back"] / n, x) < 2e-7 * n


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_rfft_differential_and_roundtrip(gloo, d):
    r = gloo[d].case("rfft")
    x = cases.inputs("rfft")["re"]
    perm = dist_fft.rspectrum_order(N, d)
    valid = perm >= 0
    got = r["re"] + 1j * r["im"]
    assert err(got[:, valid], fft64(x)[:, perm[valid]]) < TOL
    assert not got[:, ~valid].any()  # padding rows stay zero
    assert err(r["back"] / N, x) < TOL
    jspec, jback = jax_rfft()
    assert err(rnatural(got, perm), jspec) < TOL and err(r["back"], jback) < TOL * N
    assert r["placement"].tolist() == [1, 1, got.shape[-1] // d]


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_rfft_convolve_matches_numpy(gloo, d):
    y = gloo[d].case("convolve")["real"]
    i = cases.inputs("convolve")
    ref = np.fft.irfft(np.fft.rfft(i["x"].astype(np.float64)) * np.fft.rfft(i["h"].astype(np.float64)), axis=-1)
    assert err(y, ref) < 4e-6 * np.abs(ref).max()
    assert err(y, jax_convolve()[0]) < 4e-6 * np.abs(ref).max()


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_fft_batched_matches_single(gloo, d):
    """Two leading batch axes: the same rows as the (2, N) batch."""
    r = gloo[d].case("fft")
    i = cases.inputs("fft")
    got = r["lead_re"] + 1j * r["lead_im"]
    assert got.shape == (1, 2, N)
    assert err(got[0], fft64(i["re"] + 1j * i["im"])[..., dist_fft.spectrum_order(N, d)]) < TOL
    assert err((r["lead_back_re"][0] + 1j * r["lead_back_im"][0]) / N, i["re"] + 1j * i["im"]) < TOL


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_fft_convolve_matches_numpy(gloo, d):
    r = gloo[d].case("convolve")
    i = cases.inputs("convolve")
    x, h = i["x"][0] + 1j * i["x"][1], i["hr"] + 1j * i["hi"]
    ref = np.fft.ifft(fft64(x) * fft64(h))
    got = r["cre"] + 1j * r["cim"]
    assert err(got, ref) < 1e-4 * np.abs(ref).max()
    assert err(got, jax_convolve()[1]) < 1e-4 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# The sharded models, gradients, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", WORLDS)
def test_convolver_channel_sharded(gloo, d):
    """test_models.py's case, and the time-sharded form beside it."""
    r = gloo[d].case("convolver")
    i = cases.inputs("convolver")
    ref = np.stack([np.convolve(i["x"][c].astype(np.float64), i["ir"][c].astype(np.float64))[:6144]
                    for c in range(4)])
    for form in ("channel", "time"):
        assert err(r[form], ref) < 1e-3 and err(r[form], r["single"]) < 1e-4, form
    assert r["channel_placement"].tolist() == [1, 0, 6144] and r["time_placement"].tolist() == [1, 1, 6144 // d]
    assert err(r["channel"], jax_models()["convolver"]) < 1e-3


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_fir_ols_gradient(gloo, d):
    """d/dx and d/dh of sum(w * sharded_fir_ols(x, h)) equal the unsharded
    port's (rtol 1e-4 of the largest). With the hop as a plain collective
    (no autograd Function) the x gradient loses what crosses each
    boundary: the cut is silent, and large."""
    r = gloo[d].case("gradient")
    i = cases.inputs("gradient")
    x = torch.from_numpy(i["x"]).requires_grad_()
    h = torch.from_numpy(i["h"]).requires_grad_()
    (stream.fir_filter_ols(x, h) * torch.from_numpy(i["w"])).sum().backward()
    gx, gh = x.grad.numpy(), h.grad.numpy()
    assert err(r["gx"], gx) < 1e-4 * np.abs(gx).max()
    assert err(r["gh"], gh) < 1e-4 * np.abs(gh).max()
    assert err(r["cut_gx"], gx) > 1e-2 * np.abs(gx).max()


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_entries_refuse_other_devices_and_failed_collectives(gloo, d):
    """Nothing moves a tensor to the mesh's device type behind the
    caller's back, and a failed collective raises: no entry computes
    unsharded instead."""
    r = gloo[d].case("refusals")
    assert "mesh on cpu" in str(r["meta"])
    assert "injected" in str(r["a2a"]) and "injected" in str(r["hop"])


@pytest.mark.parametrize("d", [1, 2, 4])
def test_collectives_carry_values_not_views_or_aliases(gloo, d):
    """A conjugate view through the halo hop and a negative view through
    the all_to_all arrive as their values (bug class 6); no output shares
    storage with its input, on one rank too (class 5); one rank posts no
    point-to-point operation (the NCCL one-rank rule)."""
    r = gloo[d].case("views")
    i = cases.inputs("fft")
    z = (i["re"][0] + 1j * i["im"][0]).astype(np.complex64)
    zc = np.conj(z).reshape(d, -1)
    np.testing.assert_array_equal(r["ext"][:, 7:], zc)
    np.testing.assert_array_equal(r["ext"][0, :7], 0)
    for k in range(1, d):
        np.testing.assert_array_equal(r["ext"][k, :7], zc[k - 1, -7:])
    perm = dist_fft.spectrum_order(N, d)
    assert err(r["fft_re"] + 1j * r["fft_im"], fft64(np.conj(z))[perm]) < TOL
    assert not r["aliases"].any(), r["aliases"]
    assert str(r["no_p2p"]) == ""


def test_require_mesh_device_both_ways():
    """A card mesh refuses a CPU tensor, a CPU mesh a tensor elsewhere."""
    with pytest.raises(ValueError, match="mesh on cuda"):
        pmesh.require_mesh_device(torch.zeros(3), types.SimpleNamespace(device_type="cuda"))
    with pytest.raises(ValueError, match="mesh on cpu"):
        pmesh.require_mesh_device(torch.zeros(3, device="meta"), types.SimpleNamespace(device_type="cpu"))


def test_multihost_mesh_device_injection():
    """Hosts lie out as mesh rows (the time axis within a host), from
    injected (host, rank) pairs, interleaved or not; uneven hosts raise."""
    pairs = [(hst, hst * 4 + k) for hst in range(2) for k in range(4)]
    host = dict((rank, hst) for hst, rank in pairs)
    layout = pmesh.host_major_ranks(pairs)
    assert layout.shape == (2, 4)
    for row in range(2):
        assert all(host[rank] == row for rank in layout[row])
    layout2 = pmesh.host_major_ranks(pairs[::2] + pairs[1::2])
    for row in range(2):
        assert len({host[rank] for rank in layout2[row]}) == 1
    with pytest.raises(ValueError, match="uneven"):
        pmesh.host_major_ranks(pairs[:7])


def test_multihost_mesh_on_a_group(gloo):
    """On 4 ranks of 2 hosts: a (host, time) mesh, rows by host, from the
    injected pairs and from torchrun's LOCAL_WORLD_SIZE; a halo stream
    along its time axis holds to lfilter."""
    r = gloo[4].case("multihost")
    assert r["names"].tolist() == ["host", "time"]
    assert r["ranks"].tolist() == [[0, 1], [2, 3]] and r["ranks_env"].tolist() == [[0, 1], [2, 3]]
    i = cases.inputs("fir")
    assert err(r["y"], lfilter_ref(i["h"], i["x"])) < 5e-4


def test_init_multihost_single_process_noop(gloo):
    """Without a group, a single-process call is a no-op and a declared
    multi-process run that cannot name its rank raises; with a group up
    the call is idempotent and refuses another size (on the 2-rank
    group)."""
    import torch.distributed as dist

    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", env)
        parallel.init_multihost()
        parallel.init_multihost(num_processes=1, process_id=0)
        assert not dist.is_initialized()
        with pytest.raises(ValueError, match="rank"):
            parallel.init_multihost(num_processes=2)
    assert "cannot be met" in str(gloo[2].case("mesh")["resize"])


def test_mesh_builders_default_to_the_card():
    import inspect

    for fn in (parallel.dsp_mesh, parallel.channel_time_mesh, parallel.multihost_mesh, parallel.init_local_group):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda", fn.__name__


def test_parallel_exports_every_jax_name():
    """Every name JAX's parallel/__init__ exports, or its torch analog."""
    analogs = {"Mesh": "DeviceMesh", "NamedSharding": "DTensor", "P": "Shard"}
    for name in [n for n in dir(jparallel) if not n.startswith("_") and n not in ("mesh", "sharded", "dist_fft")]:
        assert hasattr(parallel, analogs.get(name, name)), name


# ---------------------------------------------------------------------------
# Pure helpers against JAX's
# ---------------------------------------------------------------------------

SPLIT_NS = [1 << 16, 1 << 17, 98304, 155520, 3 << 17, 1 << 20, 5 << 16, 1 << 24, 81920, 1 << 18]


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("real", [False, True])
def test_dist_split_matches_jax(d, real):
    """The same sizes shard the same way in both packages (the JAX
    engine's limits, ``tables.JAX_MAX_N``), or both refuse."""
    for n in SPLIT_NS:
        try:
            want = jdist._dist_split(n, d, real)
        except ValueError:
            with pytest.raises(ValueError, match="smooth"):
                dist_fft._dist_split(n, d, real)
            continue
        assert dist_fft._dist_split(n, d, real) == want, n


def test_dist_split_invalid_n_raises_cleanly():
    for bad_n in (7 * (1 << 16), 100000, 1 << 10):
        with pytest.raises(ValueError, match="smooth"):
            dist_fft._dist_split(bad_n, 8)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("n", [1 << 16, 98304, 1 << 20])
def test_spectrum_orders_match_jax(n, d, chunks):
    """Where both factors lie in the port's K4 domain or K5's, the port's
    bin orders are JAX's (both fold the same digit layout, or none)."""
    a, c = dist_fft._dist_split(n, d)
    assert all(hopper_cfft.in_domain(v) or v <= tables.JAX_MAX_SMALL_FALLBACK for v in (a, c))
    np.testing.assert_array_equal(dist_fft.spectrum_order(n, d, chunks), jdist.spectrum_order(n, d, chunks))
    np.testing.assert_array_equal(dist_fft.rspectrum_order(n, d, chunks), jdist.rspectrum_order(n, d, chunks))
    np.testing.assert_array_equal(dist_fft._dist_twiddle(n, a, True)[0], jdist._dist_twiddle(n, a, True)[0])


@pytest.mark.parametrize("rows,d,chunks", [(256, 2, 2), (384, 4, 2), (1024, 8, 4), (130, 2, 1), (136, 8, 1)])
def test_chunk_rowmap_and_padded_rows_match_jax(rows, d, chunks):
    if chunks > 1:
        np.testing.assert_array_equal(dist_fft._chunk_rowmap(rows, d, chunks), jdist._chunk_rowmap(rows, d, chunks))
    for a in (256, 384, 4096):
        assert dist_fft._rdist_rows(a, d, chunks) == jdist._rdist_rows(a, d, chunks)


def _dist_lengths():
    return [v for v in range(tables.JAX_MIN_N, tables.JAX_MAX_N + 1) if dist_fft._dist_ok_len(v)]


def test_engine_perm_is_the_ports_own_layout():
    """At every local length the split can give, ``_engine_perm`` is the
    layout of the port's unordered complex FFT, which equals JAX's
    kernel layout inside K4's domain and is natural above it (JAX's
    kernel runs to 2^17, so there the orders differ)."""
    lengths = _dist_lengths()
    assert set(lengths) == {v for v in range(256, (1 << 17) + 1)
                            if jdist._dist_ok_len(v)}
    rng = np.random.default_rng(5)
    for v in lengths:
        z = (rng.standard_normal(v) + 1j * rng.standard_normal(v)).astype(np.complex64)
        got = ct.fft_unordered(torch.from_numpy(z), engine="hopper").numpy()
        perm = dist_fft._engine_perm(v)
        assert err(got, fft64(z)[perm]) < 2e-7 * v, v
        if hopper_cfft.in_domain(v) or v <= tables.JAX_MAX_SMALL_FALLBACK:
            np.testing.assert_array_equal(perm, jdist._engine_perm(v))
        else:
            assert not np.array_equal(perm, jdist._engine_perm(v)), v


# ---------------------------------------------------------------------------
# The halo weak-scaling model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overlap", [False, True])
def test_halo_weak_scaling_model(overlap):
    """JAX's model on the port's conv_roofline, H100 and NVLink 4's
    data-sheet rate: the halo term is JAX's at the same link rate, the
    compute term the port's bound, and neither depends on the card count."""
    per, taps, block = 480000, 96000, 4096
    got = roof.halo_weak_scaling(per, taps, block, overlap_comm=overlap)
    want = jroof.halo_weak_scaling(per, taps, block, ici_bytes_per_s=roof.H100_NVLINK_BYTES_PER_S,
                                   overlap_comm=overlap)
    assert got["t_halo_s"] == pytest.approx(want["t_halo_s"], rel=1e-12)
    blocks = -(-per // block)
    assert got["t_compute_s"] == pytest.approx(roof.conv_roofline(2 * block, blocks).seconds, rel=1e-12)
    t_c, t_h = got["t_compute_s"], got["t_halo_s"]
    expect = min(1.0, t_c / max(t_c, t_h)) if overlap else t_c / (t_c + t_h)
    assert got["efficiency"] == pytest.approx(expect, rel=1e-12)
    assert roof.H100_NVLINK_BYTES_PER_S == 450e9
