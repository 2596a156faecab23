"""The rank side of tests/test_torch_parallel.py: the port's parallel layer
on a CPU gloo group, one process a rank.

    python tests/torch_parallel_cases.py RANK WORLD INIT_FILE OUT_DIR

Each rank joins the group through INIT_FILE (``file://`` rendezvous, so
concurrent test workers never share a port), runs every case of its
group size on the port's entry points, and rank 0 writes each case's
gathered results to OUT_DIR/<case>.npz (a rank where a case raised writes
the traceback to OUT_DIR/<case>.err<rank>). The inputs come from :func:`inputs`,
numpy arrays made from a seed, which the test module imports to run the
JAX package on the same arrays. This module imports no JAX, and pytest
does not collect it.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pathlib
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch import models, parallel
from chowdsp_fft_tpu_torch.parallel import dist_fft, mesh as pmesh, sharded
from chowdsp_fft_tpu_torch.parallel import CHANNEL_AXIS, TIME_AXIS

N_FFT = 1 << 16  # the smallest N whose split has both factors >= 256
N_SMOOTH = 3 * (1 << 15)  # 98304 = 384 * 256
N_ODD_TRAP = 155520  # 2^7 * 3^5 * 5: over 3 devices its balanced split has an odd A
SDR = {"channels": 16, "decimation": 2}
CONV = {"channels": 4, "block": 512}
TONE = {"channels": 16, "decimation": 2, "audio_decimation": 2, "channel": 5, "msg_f": 0.001, "steps": 1024}


def fm_carriers(c: int, dec: int, t: int, seed: int, noise: float = 0.01) -> np.ndarray:
    """An FM carrier at the centre of every channel of the post-decimation
    bank, each with its own tone, plus a little noise (as
    test_torch_sdr.py: the demod is well defined everywhere)."""
    rng = np.random.default_rng(seed)
    n = np.arange(t, dtype=np.float64)
    iq = np.zeros(t, np.complex128)
    for ch in range(c):
        f = (ch if ch < c // 2 else ch - c) / (c * dec)
        msg = np.sin(2 * np.pi * rng.uniform(0.0005, 0.002) * n + rng.uniform(0, 2 * np.pi))
        phase = 2 * np.pi * f * n + 2 * np.pi * (0.1 / (c * dec)) * np.cumsum(msg)
        iq += np.exp(1j * (phase + rng.uniform(0, 2 * np.pi)))
    iq /= np.sqrt(c)
    iq += noise * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    return iq.astype(np.complex64)


def fm_tone() -> np.ndarray:
    """test_parallel.py's FM tone in channel TONE["channel"] of the bank."""
    c, dec, steps = TONE["channels"], TONE["decimation"], TONE["steps"]
    t_wide = np.arange(c * steps * dec, dtype=np.float64)
    msg = np.sin(2 * np.pi * TONE["msg_f"] * t_wide)
    phase = 2 * np.pi * (TONE["channel"] / (c * dec)) * t_wide + 2 * np.pi * (0.1 / (c * dec)) * np.cumsum(msg)
    return np.exp(1j * phase).astype(np.complex64)


def inputs(case: str) -> dict[str, np.ndarray]:
    """Each case's inputs, from its own seed (the same arrays on every rank
    and in the test process)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    if case == "fir":  # test_sharded_fir_ols_matches_single_device, halo boundary exactness
        return {"x": f32(rng.standard_normal(4 * 2048)), "h": f32(rng.standard_normal(127) / 10)}
    if case == "fir_batched":
        return {"x": f32(rng.standard_normal((3, 4 * 1024))), "h": f32(rng.standard_normal(65) / 8)}
    if case == "pfir":  # a long filter: 2048 taps over 4 shards of 2048 samples
        return {"x": f32(rng.standard_normal(4 * 2048)), "h": f32(rng.standard_normal(2048) / np.sqrt(2048))}
    if case == "channels":
        return {"x": f32(rng.standard_normal((4, 256)))}
    if case == "sdr":
        c, dec = SDR["channels"], SDR["decimation"]
        return {"iq": fm_carriers(c, dec, 4 * c * dec * 128, seed=7), "tone": fm_tone()}
    if case in ("fft", "rfft"):  # complex planes / real rows, (2, N)
        return {"re": f32(rng.standard_normal((2, N_FFT))), "im": f32(rng.standard_normal((2, N_FFT)))}
    if case == "smooth":
        return {"re": f32(rng.standard_normal(N_SMOOTH)), "im": f32(rng.standard_normal(N_SMOOTH)),
                "x": f32(rng.standard_normal((2, N_SMOOTH)))}
    if case == "odd_trap":
        return {"x": f32(rng.standard_normal((2, N_ODD_TRAP)))}
    if case == "convolve":
        return {"x": f32(rng.standard_normal((2, N_FFT))), "h": f32(rng.standard_normal((2, N_FFT))),
                "hr": f32(rng.standard_normal(N_FFT)), "hi": f32(rng.standard_normal(N_FFT))}
    if case == "convolver":  # test_models.py's conv_setup
        return {"ir": f32(rng.standard_normal((4, 700)) / 32), "x": f32(rng.standard_normal((4, 6144)))}
    if case == "gradient":
        return {"x": f32(rng.standard_normal((2, 4 * 1024))), "h": f32(rng.standard_normal(65) / 8),
                "w": f32(rng.standard_normal((2, 4 * 1024)))}
    raise KeyError(case)


def t_(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def full(d) -> np.ndarray:
    """A DTensor gathered on every rank, as numpy."""
    return d.full_tensor().detach().numpy()


def placement(d) -> np.ndarray:
    """(is a DTensor, the dim its shard lies on or -1, local length)."""
    if not isinstance(d, parallel.DTensor):
        return np.array([0, -1, -1])
    dims = [p.dim for p in d.placements if isinstance(p, parallel.Shard)]
    return np.array([1, dims[0] if dims else -1, d.to_local().shape[-1]])


def raised(fn, exc) -> str:
    """The message of the ``exc`` that ``fn()`` raises ("" if none)."""
    try:
        fn()
    except exc as e:
        return str(e) or type(e).__name__
    return ""


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class Ctx:
    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world
        self.mesh = parallel.dsp_mesh(world, device_type="cpu")


# ---------------------------------------------------------------------------
# Cases: each returns the arrays the test module checks (gathered results)
# ---------------------------------------------------------------------------


def case_fir(ctx):
    i = inputs("fir")
    y = parallel.sharded_fir_ols(t_(i["x"]), t_(i["h"]), ctx.mesh)
    return {"y": full(y), "placement": placement(y)}


def case_fir_batched(ctx):
    i = inputs("fir_batched")
    y = parallel.sharded_fir_ols(t_(i["x"]), t_(i["h"]), ctx.mesh)
    # the same stream handed in as a DTensor already sharded over the axis
    xd = parallel.shard_channels(t_(i["x"]), ctx.mesh, TIME_AXIS, dim=-1)
    yd = parallel.sharded_fir_ols(xd, t_(i["h"]), ctx.mesh)
    return {"y": full(y), "y_dtensor_in": full(yd), "placement": placement(y)}


def case_pfir(ctx):
    i = inputs("pfir")
    return {"y": full(parallel.sharded_partitioned_fir(t_(i["x"]), t_(i["h"]), ctx.mesh, block=512))}


def case_channels(ctx):
    x = parallel.shard_channels(t_(inputs("channels")["x"]), ctx.mesh, axis_name=TIME_AXIS)
    spec = ct.rfft(x.to_local(), engine="hopper")
    return {"spec": full(pmesh.sharded(spec, ctx.mesh, TIME_AXIS, 0)), "placement": placement(x)}


def case_sdr(ctx):
    chain = models.SDRChain(models.SDRChainConfig(**SDR), device="cpu")
    iq = t_(inputs("sdr")["iq"])
    out = chain.sharded_step(ctx.mesh)(iq)
    cfg = {k: TONE[k] for k in ("channels", "decimation", "audio_decimation")}
    tone_chain = models.SDRChain(models.SDRChainConfig(**cfg), device="cpu")
    tone = tone_chain.sharded_step(ctx.mesh)(t_(inputs("sdr")["tone"]))
    return {"sharded": full(out), "single": chain(iq).numpy(), "placement": placement(out), "tone": full(tone)}


def case_guards(ctx):
    x = torch.arange(ctx.world * 64, dtype=torch.float32)
    y = parallel.sharded_fir_ols(x, torch.ones(1), ctx.mesh)  # taps 1: halo 0, no exchange
    big = raised(lambda: parallel.sharded_fir_ols(x, torch.ones(200) / 200, ctx.mesh), ValueError)
    zero = raised(lambda: sharded._ship_tail_left(x[:64], 0, ctx.mesh, TIME_AXIS), ValueError)
    # the hop itself: rank i's shard prefixed with rank i-1's last 5 samples
    own = pmesh.local_shard(x, ctx.mesh, TIME_AXIS)
    ext = parallel.halo_exchange_left(own, 5, ctx.mesh)
    rows = [torch.empty_like(ext) for _ in range(ctx.world)]
    dist.all_gather(rows, ext.contiguous())
    same = parallel.halo_exchange_left(own, 0, ctx.mesh)
    return {"y": full(y), "big": np.array(big), "zero": np.array(zero), "ext": torch.stack(rows).numpy(),
            "halo0_is_input": np.array(same is own)}


def case_overlap_order(ctx):
    """A spy on the hop and the local filter: what ran, in order."""
    events = []
    real_filter, real_init, real_wait = sharded.fir_filter_ols, sharded._PendingTail.__init__, sharded._PendingTail.wait

    def spy_filter(x, h, **kw):
        events.append(f"filter:{x.shape[-1]}")
        return real_filter(x, h, **kw)

    def spy_init(self, *a):
        events.append("post")
        real_init(self, *a)

    def spy_wait(self):
        events.append("wait")
        return real_wait(self)

    x = torch.zeros(ctx.world * 16384)
    with patched(sharded, "fir_filter_ols", spy_filter), patched(sharded._PendingTail, "__init__", spy_init), \
            patched(sharded._PendingTail, "wait", spy_wait):
        parallel.sharded_fir_ols(x, torch.ones(257), ctx.mesh, block=1024)
    return {"events": np.array(events)}


def case_mesh(ctx):
    too_many = raised(lambda: parallel.dsp_mesh(64, device_type="cpu"), ValueError)
    too_many_2d = raised(lambda: parallel.channel_time_mesh(8, 8, device_type="cpu"), ValueError)
    m2 = parallel.channel_time_mesh(1, ctx.world, device_type="cpu")
    parallel.init_multihost()  # idempotent with the group up
    parallel.init_multihost(num_processes=ctx.world)
    resize = raised(lambda: parallel.init_multihost(num_processes=ctx.world + 1), RuntimeError)
    return {"too_many": np.array(too_many), "too_many_2d": np.array(too_many_2d), "resize": np.array(resize),
            "names_2d": np.array(m2.mesh_dim_names), "shape_2d": np.array(m2.mesh.shape),
            "names_1d": np.array(ctx.mesh.mesh_dim_names), "device_type": np.array(ctx.mesh.device_type)}


def case_multihost(ctx):
    """(host, time) mesh from injected (host, rank) pairs and from
    torchrun's LOCAL_WORLD_SIZE; a halo stream along its time axis."""
    pairs = [(r // 2, r) for r in range(ctx.world)]
    m = parallel.multihost_mesh(devices=pairs, device_type="cpu")
    with patched(os, "environ", {**os.environ, "LOCAL_WORLD_SIZE": "2"}):
        m_env = parallel.multihost_mesh(device_type="cpu")
    i = inputs("fir")
    y = parallel.sharded_fir_ols(t_(i["x"]), t_(i["h"]), m, axis_name=TIME_AXIS)
    return {"names": np.array(m.mesh_dim_names), "ranks": m.mesh.numpy(), "ranks_env": m_env.mesh.numpy(),
            "y": full(y)}


def case_fft(ctx):
    i = inputs("fft")
    re, im = parallel.sharded_fft_planes(t_(i["re"]), t_(i["im"]), ctx.mesh)
    br, bi = parallel.sharded_ifft_planes(re, im, ctx.mesh)
    # unbatched, and batched over two leading axes
    ur, ui = parallel.sharded_fft_planes(t_(i["re"][0]), t_(i["im"][0]), ctx.mesh)
    lr, li = parallel.sharded_fft_planes(t_(i["re"][None]), t_(i["im"][None]), ctx.mesh)
    lbr, lbi = parallel.sharded_ifft_planes(lr, li, ctx.mesh)
    return {"re": full(re), "im": full(im), "back_re": full(br), "back_im": full(bi),
            "un_re": full(ur), "un_im": full(ui), "lead_re": full(lr), "lead_im": full(li),
            "lead_back_re": full(lbr), "lead_back_im": full(lbi), "placement": placement(re)}


def case_smooth(ctx):
    i = inputs("smooth")
    re, im = parallel.sharded_fft_planes(t_(i["re"]), t_(i["im"]), ctx.mesh)
    br, bi = parallel.sharded_ifft_planes(re, im, ctx.mesh)
    rr, ri = parallel.sharded_rfft_planes(t_(i["x"]), ctx.mesh)
    xb = parallel.sharded_irfft_planes(rr, ri, ctx.mesh, N_SMOOTH)
    return {"re": full(re), "im": full(im), "back_re": full(br), "back_im": full(bi), "xback": full(xb)}


def case_odd_trap(ctx):
    x = t_(inputs("odd_trap")["x"])
    re, im = parallel.sharded_rfft_planes(x, ctx.mesh)
    back = parallel.sharded_irfft_planes(re, im, ctx.mesh, N_ODD_TRAP)
    return {"re": full(re), "im": full(im), "back": full(back)}


def case_rfft(ctx):
    x = t_(inputs("rfft")["re"])
    re, im = parallel.sharded_rfft_planes(x, ctx.mesh)
    back = parallel.sharded_irfft_planes(re, im, ctx.mesh, N_FFT)
    return {"re": full(re), "im": full(im), "back": full(back), "placement": placement(re)}


def _a2a_calls(fn) -> tuple:
    dist_fft.TRANSPOSES.calls = 0
    out = fn()
    return out, dist_fft.TRANSPOSES.calls


def case_pipeline_chunks(ctx):
    x = t_(inputs("rfft")["re"])
    (r1, i1), c1 = _a2a_calls(lambda: parallel.sharded_rfft_planes(x, ctx.mesh))
    (r2, i2), c2 = _a2a_calls(lambda: parallel.sharded_rfft_planes(x, ctx.mesh, pipeline_chunks=2))
    back = parallel.sharded_irfft_planes(r2, i2, ctx.mesh, N_FFT, pipeline_chunks=2)
    unbatched = raised(lambda: parallel.sharded_rfft_planes(x[0], ctx.mesh, pipeline_chunks=2), ValueError)
    i = inputs("fft")
    z, zi = t_(i["re"]), t_(i["im"])
    cr1, ci1 = parallel.sharded_fft_planes(z, zi, ctx.mesh)
    cr2, ci2 = parallel.sharded_fft_planes(z, zi, ctx.mesh, pipeline_chunks=2)
    return {"r1": full(r1), "i1": full(i1), "r2": full(r2), "i2": full(i2), "back": full(back),
            "calls": np.array([c1, c2]), "unbatched": np.array(unbatched),
            "cr1": full(cr1), "ci1": full(ci1), "cr2": full(cr2), "ci2": full(ci2)}


def case_transform_chunks(ctx, g: int = 2):
    i = inputs("fft")
    z, zi = t_(i["re"][0]), t_(i["im"][0])
    (re, im), calls = _a2a_calls(lambda: parallel.sharded_fft_planes(z, zi, ctx.mesh, transform_chunks=g))
    br, bi = parallel.sharded_ifft_planes(re, im, ctx.mesh, transform_chunks=g)
    x = t_(inputs("rfft")["re"])
    rr, ri = parallel.sharded_rfft_planes(x, ctx.mesh, transform_chunks=g)
    xb = parallel.sharded_irfft_planes(rr, ri, ctx.mesh, N_FFT, transform_chunks=g)
    bad = raised(lambda: parallel.sharded_fft_planes(z, zi, ctx.mesh, transform_chunks=3), ValueError)
    return {"re": full(re), "im": full(im), "back_re": full(br), "back_im": full(bi), "rre": full(rr),
            "rim": full(ri), "xback": full(xb), "calls": np.array(calls), "bad": np.array(bad)}


def case_convolve(ctx):
    i = inputs("convolve")
    y = parallel.sharded_rfft_convolve(t_(i["x"]), t_(i["h"]), ctx.mesh)
    yr, yi = parallel.sharded_fft_convolve(t_(i["x"][0]), t_(i["x"][1]), t_(i["hr"]), t_(i["hi"]), ctx.mesh)
    return {"real": full(y), "cre": full(yr), "cim": full(yi)}


def case_convolver(ctx):
    i = inputs("convolver")
    conv = models.MultichannelConvolver(t_(i["ir"]), models.ConvolverConfig(**CONV), device="cpu")
    cmesh = parallel.dsp_mesh(ctx.world, axis=CHANNEL_AXIS, device_type="cpu")
    x = t_(i["x"])
    ych = conv.channel_sharded_apply(cmesh)(x)
    yt = conv.time_sharded_apply(ctx.mesh, TIME_AXIS)(x)
    return {"single": conv.apply(x).numpy(), "channel": full(ych), "time": full(yt),
            "channel_placement": placement(ych), "time_placement": placement(yt)}


def _grads(ctx, i):
    x = t_(i["x"]).requires_grad_()
    h = t_(i["h"]).requires_grad_()
    y = parallel.sharded_fir_ols(x, h, ctx.mesh)
    w = pmesh.local_shard(t_(i["w"]), ctx.mesh, TIME_AXIS)
    (y.to_local() * w).sum().backward()
    return x.grad.numpy(), h.grad.numpy()


def case_gradient(ctx):
    """The gradient of sum(w * sharded_fir_ols(x, h)) with respect to x and
    h; then the same with the hop as a plain collective (no autograd
    Function), which cuts the graph at the boundary."""
    i = inputs("gradient")
    gx, gh = _grads(ctx, i)
    plain = lambda tail, pending: pending.wait()  # noqa: E731
    with patched(sharded._HaloHop, "apply", plain):
        cx, ch = _grads(ctx, i)
    return {"gx": gx, "gh": gh, "cut_gx": cx, "cut_gh": ch}


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def case_views(ctx):
    """Lazy views and aliasing at the collectives (bug classes 5 and 6): a
    conjugate view through the halo hop and a negative view through the
    all_to_all carry their values, not their memory; no output shares
    storage with an input (on one rank too, where the all_to_all is a
    copy); one rank posts no point-to-point operation at all."""
    i = inputs("fft")
    z = torch.complex(t_(i["re"][0]), t_(i["im"][0]))
    own = pmesh.local_shard(z, ctx.mesh, TIME_AXIS)
    ext = parallel.halo_exchange_left(own.conj(), 7, ctx.mesh)  # a conjugate view in
    rows = [torch.empty_like(ext) for _ in range(ctx.world)]
    dist.all_gather(rows, ext.resolve_conj().contiguous())
    zc = z.conj()  # zc.imag is a negative view of z's imaginary plane
    fr, fi = parallel.sharded_fft_planes(zc.real, zc.imag, ctx.mesh)
    x = t_(inputs("fir")["x"])
    y = parallel.sharded_fir_ols(x, torch.ones(5) / 5, ctx.mesh)
    send = torch.arange(ctx.world * 6, dtype=torch.float32).reshape(ctx.world, 6)
    recv = dist_fft.all_to_all(send, pmesh.axis_group(ctx.mesh, TIME_AXIS)[0])
    aliases = [_shares_storage(recv, send), _shares_storage(y.to_local(), x), _shares_storage(ext, own),
               _shares_storage(fr.to_local(), zc), _shares_storage(fi.to_local(), zc)]
    no_p2p = ""
    if ctx.world == 1:
        def refuse(*a, **kw):
            raise RuntimeError("a point-to-point operation was posted on one rank")
        with patched(dist, "batch_isend_irecv", refuse):
            no_p2p = raised(lambda: parallel.sharded_fir_ols(x, torch.ones(9), ctx.mesh), RuntimeError)
    return {"ext": torch.stack(rows).numpy(), "fft_re": full(fr), "fft_im": full(fi),
            "aliases": np.array(aliases), "no_p2p": np.array(no_p2p)}


def case_refusals(ctx):
    """No entry moves a tensor between device types, and none falls back
    to an unsharded computation when a collective fails."""
    meta = raised(lambda: parallel.sharded_fir_ols(torch.zeros(ctx.world * 64, device="meta"), torch.ones(3),
                                                   ctx.mesh), ValueError)

    def broken(*a, **kw):
        raise RuntimeError("collective failed (injected)")

    x = t_(inputs("fft")["re"])
    with patched(dist, "all_to_all_single", broken):
        a2a = raised(lambda: parallel.sharded_fft_planes(x, x, ctx.mesh), RuntimeError)
    with patched(dist, "batch_isend_irecv", broken):
        hop = raised(lambda: parallel.sharded_fir_ols(x[0], torch.ones(9), ctx.mesh), RuntimeError)
    return {"meta": np.array(meta), "a2a": np.array(a2a), "hop": np.array(hop)}


CASES = {
    "fir": case_fir,
    "fir_batched": case_fir_batched,
    "pfir": case_pfir,
    "channels": case_channels,
    "sdr": case_sdr,
    "guards": case_guards,
    "overlap_order": case_overlap_order,
    "mesh": case_mesh,
    "fft": case_fft,
    "smooth": case_smooth,
    "rfft": case_rfft,
    "pipeline_chunks": case_pipeline_chunks,
    "transform_chunks": case_transform_chunks,
    "convolve": case_convolve,
    "convolver": case_convolver,
    "gradient": case_gradient,
    "refusals": case_refusals,
    "multihost": case_multihost,
    "odd_trap": case_odd_trap,
    "views": case_views,
}
GROUPS = {
    1: ["views"],
    2: [name for name in CASES if name not in ("multihost", "odd_trap")],
    3: ["fir", "odd_trap"],
    4: [name for name in CASES if name != "odd_trap"],
}


def main(rank: int, world: int, init_file: str, out_dir: str) -> int:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    out = pathlib.Path(out_dir)
    try:
        ctx = Ctx(rank, world)
        for name in GROUPS[world]:
            try:
                result = CASES[name](ctx)
            except Exception:  # a case's failure is its test's to report; the other cases still run
                (out / f"{name}.err{rank}").write_text(traceback.format_exc())
            else:
                if rank == 0:
                    np.savez(out / f"{name}.npz", **result)
            dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]))
