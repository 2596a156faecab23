"""The offline frequency-domain delay line (``ops.convolve.
convolve_accumulate_partitioned``, ``csrc/partitioned_accumulate.cu``).

On the CPU: the plain version and the autograd Function against the FDL
as a per-partition loop of shifted copies and packed
convolve-accumulates (inlined here), forward and gradients; a numpy model of the kernel's walk (register ring of
sub-rings, runs with their halo, passes over partition chunks) against
the plain version; ``meta`` shapes. Marked ``cuda``: the kernel against
the plain version on the card, its launch count, the ops between K1 and
K2 in ``apply_offline``, and the caller's tensors left alone. Run on the
card with

    python -m pytest -m cuda tests/test_torch_partitioned_accumulate.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chowdsp_fft_tpu_torch import models, stream
from chowdsp_fft_tpu_torch.ops import autodiff, convolve
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf


def loop_reference(xre, xim, hre, him, scale):
    """The FDL partition by partition: each partition's product with the
    block spectra shifted down p blocks, accumulated."""
    nb = xre.shape[-2]
    acc = None
    for p in range(min(hre.shape[-2], nb)):
        xr_p = xre if p == 0 else F.pad(xre[..., : nb - p, :], (0, 0, p, 0))
        xi_p = xim if p == 0 else F.pad(xim[..., : nb - p, :], (0, 0, p, 0))
        hr, hi = hre[..., p, :], him[..., p, :]
        if hr.ndim > 1:
            hr, hi = hr[..., None, :], hi[..., None, :]
        acc = convolve.convolve_accumulate_packed((xr_p, xi_p), (hr, hi), ab=acc, scaling=scale)
    return acc


def planes(shape, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device) for _ in range(2))


def gap(got, want) -> float:
    """max |got - want| / rms(want) over both planes."""
    g, w = torch.stack([t.double() for t in got]), torch.stack([t.double() for t in want])
    return float((g - w).abs().max() / w.pow(2).mean().sqrt())


# (x leading dims, h leading dims): a filter per stream, one shared
# filter, and leading batch dims the filter broadcasts along.
FILTERS = {"per_stream": ((3,), (3,)), "shared": ((2, 3), ()), "batch": ((2, 3), (3,))}


def case(kind, nb, m, partitions, seed):
    x_lead, h_lead = FILTERS[kind]
    x = planes((*x_lead, nb, m), seed)
    h = tuple(t / partitions for t in planes((*h_lead, partitions, m), seed + 1))
    return x, h


@pytest.mark.parametrize("m", [128, 1024])
@pytest.mark.parametrize("partitions", [1, 3, 7, 9])  # P = 1, P < nb, P = nb, P > nb
@pytest.mark.parametrize("kind", sorted(FILTERS))
def test_plain_forward_and_gradients_match_the_loop(kind, partitions, m):
    nb = 7
    x, h = case(kind, nb, m, partitions, 100 * partitions + m)
    scale = 1.0 / (2 * m)
    want = loop_reference(*x, *h, scale)
    got = convolve.convolve_accumulate_partitioned(x, h, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    leaves = [t.clone().requires_grad_() for t in (*x, *h)]
    ref_leaves = [t.clone().requires_grad_() for t in (*x, *h)]
    w = planes(want[0].shape, 7)
    out = autodiff.PartitionedAccumulate.apply(*leaves, scale)
    ref = loop_reference(*ref_leaves, scale)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    loss = sum((o * wt).sum() for o, wt in zip(out, w))
    ref_loss = sum((o * wt).sum() for o, wt in zip(ref, w))
    grads = torch.autograd.grad(loss, leaves)
    ref_grads = torch.autograd.grad(ref_loss, ref_leaves)
    for g, r, leaf in zip(grads, ref_grads, leaves):
        assert g.shape == leaf.shape
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * float(r.abs().max()))


def test_gradient_to_one_input_only():
    """With only H requiring grad (a learned IR on fixed audio), the
    backward returns H's gradient alone."""
    x, h = case("per_stream", 6, 128, 4, 5)
    hre = h[0].clone().requires_grad_()
    out = autodiff.PartitionedAccumulate.apply(*x, hre, h[1], 0.25)
    (g,) = torch.autograd.grad(out[0].sum() + out[1].sum(), [hre])
    ref_h = h[0].clone().requires_grad_()
    ref = loop_reference(*x, ref_h, h[1], 0.25)
    (r,) = torch.autograd.grad(ref[0].sum() + ref[1].sum(), [ref_h])
    torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * float(r.abs().max()))


def test_meta_tensors_give_shapes():
    x = tuple(torch.empty(2, 3, 9, 256, device="meta") for _ in range(2))
    h = tuple(torch.empty(3, 4, 256, device="meta") for _ in range(2))
    y = convolve.convolve_accumulate_partitioned(x, h, 0.5)
    assert all(t.device.type == "meta" and t.shape == (2, 3, 9, 256) for t in y)
    y = autodiff.PartitionedAccumulate.apply(*x, *h, 0.5)
    assert all(t.device.type == "meta" and t.shape == (2, 3, 9, 256) for t in y)


def kernel_model(xre, xim, hre, him, scale, groups, run):
    """The CUDA kernel's walk in numpy float32, vectorised over streams and
    slots: per run of blocks and per chunk of 8*groups partitions, the
    filter in a register ring of ``groups`` sub-rings of 8 accumulators,
    rows walked in batches of 8, the finished output stored from
    sub-ring 0 and each sub-ring's finished slot handed to the one
    before. Outputs the walk never writes stay NaN."""
    xre, xim, hre, him = (t.numpy() for t in (xre, xim, hre, him))
    streams, nb, m = xre.shape
    partitions = hre.shape[1]
    hre, him = (np.broadcast_to(t, (streams, partitions, m)) for t in (hre, him))
    pc = 8 * groups
    yre = np.full((streams, nb, m), np.nan, np.float32)
    yim = np.full_like(yre, np.nan)
    dc = np.arange(m) == 0
    zero = np.zeros((streams, m), np.float32)
    scale = np.float32(scale)
    for b0 in range(0, nb, run):
        b1 = min(nb, b0 + run)
        for p_lo in range(0, min(partitions, b1), pc):
            hr = [[hre[:, p] if p < partitions else zero for p in range(p_lo + 8 * g, p_lo + 8 * g + 8)]
                  for g in range(groups)]
            hi = [[him[:, p] if p < partitions else zero for p in range(p_lo + 8 * g, p_lo + 8 * g + 8)]
                  for g in range(groups)]
            ar = [[zero.copy() for _ in range(8)] for _ in range(groups)]
            ai = [[zero.copy() for _ in range(8)] for _ in range(groups)]
            j0, j1 = max(0, b0 - p_lo - pc + 1), b1 - p_lo
            for jj in range(j0, j1, 8):
                for t in range(8):
                    j = jj + t
                    xr, xi = (xre[:, j], xim[:, j]) if j < j1 else (zero, zero)
                    a_r, a_i = xr, np.where(dc, 0, xi).astype(np.float32)
                    c_r, c_i = np.where(dc, xi, xr).astype(np.float32), a_i
                    for g in range(groups):
                        for u in range(8):
                            i = (t + u) % 8
                            ar[g][i] = ar[g][i] + a_r * hr[g][u] - a_i * hi[g][u]
                            ai[g][i] = ai[g][i] + c_r * hi[g][u] + c_i * hr[g][u]
                    b = j + p_lo
                    if j < j1 and b >= b0:
                        vr, vi = ar[0][t] * scale, ai[0][t] * scale
                        if p_lo == 0:
                            yre[:, b], yim[:, b] = vr, vi
                        else:
                            yre[:, b] += vr
                            yim[:, b] += vi
                    for g in range(groups - 1):
                        ar[g][t], ai[g][t] = ar[g + 1][t], ai[g + 1][t]
                    ar[groups - 1][t], ai[groups - 1][t] = zero.copy(), zero.copy()
    return torch.from_numpy(yre), torch.from_numpy(yim)


@pytest.mark.parametrize("streams,nb,m,partitions,shared,run", [
    (2, 9, 128, 1, False, None),
    (2, 9, 128, 5, False, None),
    (2, 9, 128, 9, True, None),
    (2, 9, 192, 13, False, None),  # P > nb, a ragged tile of slots
    (3, 40, 128, 35, True, None),  # two passes of 32 partitions
    (2, 40, 128, 13, False, 6),  # runs of 6 blocks, each re-reading 15 rows before it
    (1, 70, 128, 24, False, 16),  # the cell's P in runs, the last one short
])
def test_kernel_walk_matches_plain(streams, nb, m, partitions, shared, run):
    x = planes((streams, nb, m), nb + partitions)
    h = tuple(t / partitions for t in planes((1 if shared else streams, partitions, m), nb))
    groups, auto_run = convolve.partitioned_geometry(streams, nb, m, partitions)
    got = kernel_model(*x, *h, 0.125, groups, run or auto_run)
    want = convolve.convolve_accumulate_partitioned_plain(x, h, 0.125)
    assert not any(bool(t.isnan().any()) for t in got)
    # float32 sums of up to 35 products in another order: a few eps of the
    # largest output; a lost or doubled partition reads ~1e-1
    assert gap(got, want) <= 1e-5


def test_geometry():
    # the reverb: whole streams (2048 blocks fill the card), 3 sub-rings for 24 partitions
    assert convolve.partitioned_geometry(64, 118, 4096, 24) == (3, 118)
    # partitions beyond the blocks reach no output; more than 32 take passes of 32
    assert convolve.partitioned_geometry(64, 5, 4096, 24)[0] == 1
    assert convolve.partitioned_geometry(64, 500, 4096, 750)[0] == 4
    # one long stream splits into runs of at least twice the partitions held
    groups, run = convolve.partitioned_geometry(1, 1000, 1024, 24)
    assert groups == 3 and run >= 2 * 24 and -(-1000 // run) > 1
    assert convolve.partitioned_geometry(1, 10, 1024, 24) == (2, 10)


def test_records():
    assert convolve.KERNELS == (convolve.PARTITIONED, convolve.PACKED_PRODUCT)
    assert convolve.PARTITIONED not in hf.KERNELS
    assert convolve.PARTITIONED.source.endswith("csrc/partitioned_accumulate.cu")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("x_lead,h_lead,nb,m,partitions", [
    ((64,), (64,), 118, 4096, 24),  # the reverb's shape
    ((3,), (1,), 37, 192, 35),
    ((5,), (5,), 9, 640, 1),
    ((2,), (2,), 200, 1024, 24),  # few streams: runs
    ((4,), (1,), 6, 4032, 11),  # P > nb, ragged slots
    # the wrapper's broadcasts: FILTERS' kinds, a 2-D (P, M) filter, a
    # filter along some batch dims only, and x broadcast against h
    (FILTERS["per_stream"][0], FILTERS["per_stream"][1], 13, 256, 9),
    (FILTERS["shared"][0], FILTERS["shared"][1], 13, 256, 9),
    (FILTERS["batch"][0], FILTERS["batch"][1], 13, 256, 9),
    ((5,), (), 40, 1024, 24),
    ((2, 3), (2, 1), 11, 384, 5),
    ((1,), (3,), 12, 512, 4),
])
def test_kernel_matches_plain(dev, x_lead, h_lead, nb, m, partitions):
    x = planes((*x_lead, nb, m), nb, dev)
    h = tuple(t / partitions for t in planes((*h_lead, partitions, m), m, dev))
    before = convolve.PARTITIONED.launches
    got = convolve.convolve_accumulate_partitioned(x, h, 1.0 / (2 * m))
    torch.cuda.synchronize()
    assert convolve.PARTITIONED.launches == before + 1
    want = convolve.convolve_accumulate_partitioned_plain(x, h, 1.0 / (2 * m))
    assert all(a.shape == b.shape for a, b in zip(got, want))
    assert gap(got, want) <= 1e-5


@pytest.mark.cuda
def test_apply_offline_runs_one_kernel_between_k1_and_k2(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ir = planes((4, 3000), 1, dev)[0] / 64
    x = planes((4, 20000), 2, dev)[0]
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=4, block=512), device=dev)
    want = stream.PartitionedFIR(ir.cpu(), block=512).apply_offline(x.cpu())
    conv.apply(x)  # build and warm
    torch.cuda.synchronize()
    before = convolve.PARTITIONED.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = conv.apply(x)
        torch.cuda.synchronize()
    assert convolve.PARTITIONED.launches == before + 1
    ops = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    names = [e.name for e in ops]
    k1 = next(i for i, n in enumerate(names) if "rfft_packed_kernel" in n and "irfft" not in n)
    k2 = next(i for i, n in enumerate(names) if "irfft_packed_kernel" in n)
    assert len(names[k1 + 1 : k2]) == 1 and "partitioned_accumulate_kernel" in names[k1 + 1]
    assert float((y.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_callers_tensors_are_left_alone(dev):
    h_re, h_im = planes((3, 5, 256), 3, dev)
    x = planes((3, 4096), 4, dev)[0]
    keep = [t.clone() for t in (h_re, h_im, x)]
    fir = stream.PartitionedFIR.from_spectra(h_re, h_im, 256)
    y = fir.apply_offline(x)
    xs = planes((3, 9, 256), 5, dev)
    xkeep = [t.clone() for t in xs]
    out = convolve.convolve_accumulate_partitioned(xs, (h_re, h_im), 0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((h_re, h_im, x, *xs), (*keep, *xkeep)))
    assert not any(o.data_ptr() == t.data_ptr() for o in out for t in (*xs, h_re, h_im))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
