"""The packed spectral product (``ops.convolve.convolve_accumulate_packed``,
``csrc/packed_product.cu``).

On the CPU: the entry bit for bit the torch ops it ran before the kernel
(inlined here), for a filter per stream, a shared filter and a matched
batch, with and without an accumulator, with a number and with tensor
scalings; the routing rule (the plain ops on the CPU and ``meta`` and for a
tensor ``scaling`` of more than one element, the kernel on CUDA planes,
``autodiff.PackedProduct`` only where a CUDA plane needs grad); the
Function's backward against ``torch.autograd`` through the plain version;
the kernel wrapper's refusals on every device; the record, its launch span
and the source's constants; the operands the wrapper hands the kernel (b
in its three shapes, a copy only where a plane is laid out otherwise); and
a numpy model of the kernel's walk (the units, the frames a unit walks
with b held in registers) bit for bit against the plain version. Marked
``cuda``: the kernel ``torch.equal`` to the plain version at the long-IR
cell's shape and others; planes that require grad under ``no_grad``; one
launch and no other op under ``ops.convolve.accumulate_packed`` in a
long-IR call; the gradients. Run on the card with

    python -m pytest -m cuda tests/test_torch_packed_product.py
"""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from chowdsp_fft_tpu_torch import api
from chowdsp_fft_tpu_torch.ops import _cuda, autodiff, convolve
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf
from chowdsp_fft_tpu_torch.utils import tracing

SOURCE = pathlib.Path(convolve.__file__).resolve().parents[1] / "csrc" / "packed_product.cu"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def old_product(a, b, ab=None, scaling=1.0):
    """``convolve_accumulate_packed`` as it ran before the kernel."""
    a_re, a_im = a
    b_re, b_im = b
    pr = a_re * b_re - a_im * b_im
    pi = a_re * b_im + a_im * b_re
    pr = torch.cat([a_re[..., :1] * b_re[..., :1], pr[..., 1:]], dim=-1)
    pi = torch.cat([a_im[..., :1] * b_im[..., :1], pi[..., 1:]], dim=-1)
    if not (isinstance(scaling, (int, float)) and scaling == 1.0):
        s = scaling.to(dtype=torch.float32, device=pr.device) if isinstance(scaling, torch.Tensor) else float(scaling)
        pr, pi = pr * s, pi * s
    if ab is None:
        return pr, pi
    return ab[0] + pr, ab[1] + pi


def planes(shape, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*shape, generator=g).to(device) for _ in range(2))


# (what, a shape, b shape, an ab shape or None): the callers' broadcasts.
CASES = {
    "per-stream filter (the long-IR cell's, small)": ((4, 2, 64), (4, 1, 64)),
    "shared filter": ((3, 5, 48), (48,)),
    "shared filter with leading ones": ((6, 40), (1, 1, 40)),
    "matched batch": ((2, 3, 32), (2, 3, 32)),
    "one row": ((16,), (16,)),
    "odd M": ((3, 2, 37), (3, 1, 37)),
    "M = 1": ((5, 1), (5, 1)),
    "filter broadcast over the streams": ((4, 3, 24), (1, 3, 24)),
    "filters in two leading dims": ((2, 3, 4, 20), (2, 3, 1, 20)),
    "a that broadcasts against b": ((2, 12), (3, 1, 12)),
}
SCALINGS = {
    "unit": 1.0,
    "1/n": 1.0 / 128,
    "1/3": 1.0 / 3,
    "a 0-d tensor": torch.tensor(0.3),
    "a (1, 1, 1, 1) float64 tensor": torch.tensor([[[[0.7]]]], dtype=torch.float64),
    "a tensor per slot": None,  # torch.linspace over M: the plain ops
}


def scaling_for(name, m):
    return torch.linspace(0.5, 1.5, m) if name == "a tensor per slot" else SCALINGS[name]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("scaling", sorted(SCALINGS))
@pytest.mark.parametrize("with_ab", [False, True])
def test_cpu_path_is_bit_for_bit_the_old_ops(case, scaling, with_ab):
    a_shape, b_shape = CASES[case]
    a, b = planes(a_shape, 1), planes(b_shape, 2)
    s = scaling_for(scaling, a_shape[-1])
    ab = planes(torch.broadcast_shapes(a_shape, b_shape), 3) if with_ab else None
    want = old_product(a, b, ab, s)
    for got in (convolve.convolve_accumulate_packed(a, b, ab, s), api.convolve_accumulate_packed(a, b, ab=ab,
                                                                                               scaling=s),
                convolve.convolve_accumulate_packed_plain(a, b, ab, s)):
        assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))


def test_the_accumulator_is_not_updated_in_place():
    a, b, ab = planes((3, 2, 16), 4), planes((3, 1, 16), 5), planes((3, 2, 16), 6)
    kept = tuple(t.clone() for t in ab)
    convolve.convolve_accumulate_packed(a, b, ab, 0.5)
    assert all(torch.equal(t, k) for t, k in zip(ab, kept))


def test_routing_on_the_cpu_and_meta(monkeypatch):
    """The CPU and ``meta`` take the plain ops, with or without grad."""
    calls = []
    monkeypatch.setattr(autodiff.PackedProduct, "apply", lambda *a: calls.append("PackedProduct"))
    monkeypatch.setattr(convolve, "packed_product_kernel", lambda *a: calls.append("kernel"))
    a, b = planes((3, 2, 16), 7), planes((3, 1, 16), 8)
    convolve.convolve_accumulate_packed(a, b, scaling=0.25)
    al = tuple(t.clone().requires_grad_() for t in a)
    y = convolve.convolve_accumulate_packed(al, b, scaling=0.25)
    assert y[0].grad_fn is not None
    meta = tuple(t.to("meta") for t in a), tuple(t.to("meta") for t in b)
    assert convolve.convolve_accumulate_packed(*meta, scaling=torch.tensor(0.5))[0].device.type == "meta"
    assert calls == []
    assert not convolve.takes_kernel(a, b) and not convolve.takes_kernel(*meta)


@pytest.mark.parametrize("scaling, kernel", [
    (0.5, True), (1.0, True), (torch.tensor(0.5), True), (torch.tensor([[0.5]]), True),
    (torch.linspace(0.5, 1.0, 16), False), (torch.tensor(0.5, requires_grad=True), False),
])
@pytest.mark.parametrize("grad", [False, True])
def test_routing_where_the_planes_take_the_kernel(monkeypatch, scaling, kernel, grad):
    """The rule on planes that lie on the card (the device rule stubbed):
    the kernel for a number or a one-element tensor ``scaling`` that needs
    no grad, through ``PackedProduct`` where a plane needs grad and grad
    mode is on (under ``no_grad`` the kernel gets the planes detached); the
    plain ops for any other tensor ``scaling``."""
    calls = []

    def stub(a, b, ab, scaling):
        assert not any(t.requires_grad for t in (*a, *b))
        calls.append("kernel")
        return a

    monkeypatch.setattr(_cuda, "takes_plain", lambda name, *xs: False)
    monkeypatch.setattr(autodiff.PackedProduct, "apply", lambda *a: calls.append("PackedProduct") or (a[0], a[1]))
    monkeypatch.setattr(convolve, "packed_product_kernel", stub)
    plain = convolve.convolve_accumulate_packed_plain
    monkeypatch.setattr(convolve, "convolve_accumulate_packed_plain",
                        lambda *a: calls.append("plain") or plain(*a))
    a, b = planes((3, 2, 16), 9), planes((3, 1, 16), 10)
    if grad:
        a = tuple(t.clone().requires_grad_() for t in a)
    assert convolve.takes_kernel(a, b, None, scaling) == kernel
    convolve.convolve_accumulate_packed(a, b, None, scaling)
    assert calls == [("PackedProduct" if grad else "kernel") if kernel else "plain"]
    calls.clear()
    with torch.no_grad():
        convolve.convolve_accumulate_packed(a, b, None, scaling)
    assert calls == ["kernel" if kernel else "plain"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_kernel_wrapper_refusals_on_any_device(device):
    a, b = planes((4, 2, 64), 11, device), planes((4, 1, 64), 12, device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        convolve.packed_product_kernel(a, b)
    with pytest.raises(TypeError, match="float32"):
        convolve.packed_product_kernel(tuple(t.double() for t in a), b)
    with pytest.raises(ValueError, match="expected shape"):
        convolve.packed_product_kernel((a[0], a[1][:, :1]), b)
    with pytest.raises(ValueError, match="0-d"):
        convolve.packed_product_kernel((a[0][0, 0, 0], a[1][0, 0, 0]), b)
    with pytest.raises(ValueError, match="one element"):
        convolve.packed_product_kernel(a, b, None, torch.ones(2, device=device))
    with pytest.raises(RuntimeError, match="takes no input that requires grad"):
        convolve.packed_product_kernel(a, (b[0].clone().requires_grad_(), b[1]))
    with pytest.raises(ValueError, match="expected a tensor on"):
        convolve.packed_product_kernel(a, tuple(torch.empty_like(t, device="meta" if device == "cpu" else "cpu")
                                                for t in b))


@pytest.mark.parametrize("scaling", [0.5, torch.tensor([[[[0.5]]]])])
def test_meta_tensors_give_shapes(scaling):
    a = tuple(torch.empty(64, 2, 1 << 18, device="meta") for _ in range(2))
    b = tuple(torch.empty(64, 1, 1 << 18, device="meta") for _ in range(2))
    yre, yim = api.convolve_accumulate_packed(a, b, ab=a, scaling=scaling)
    want = (64, 2, 1 << 18) if isinstance(scaling, float) else (1, 64, 2, 1 << 18)
    assert yre.shape == yim.shape == want and yre.device.type == "meta" and yre.dtype == torch.float32


def test_records():
    k = convolve.PACKED_PRODUCT
    assert convolve.KERNELS == (convolve.PARTITIONED, k)
    assert k not in hf.KERNELS
    assert k.name == "packed_product_kernel" and k.source.endswith("csrc/packed_product.cu")
    assert k.span == "ops._cuda.launch.packed_product_kernel" and k.span in tracing.SPANS
    assert "chowdsp_fft_tpu/ops/convolve.py" in k.replaces and k.replaces.startswith("none")
    assert "packed_product" in _cuda._SIGNATURES
    assert len(_cuda._SIGNATURES["packed_product"]) == 17


def _source_ints() -> dict[str, int]:
    return {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE.read_text())}


def test_constants_match_the_source():
    c = _source_ints()
    assert (convolve.PRODUCT_THREADS, convolve.PRODUCT_WIDE) == (c["kThreads"], c["kWide"])
    text = SOURCE.read_text()
    assert all(op in text for op in ("__fmul_rn", "__fsub_rn", "__fadd_rn"))
    assert "fmaf" not in text and "__fmaf" not in text and "fast" not in _cuda.NVCC_FLAGS
    assert convolve.PRODUCT_MIN_BLOCKS == c["kMinBlocks"] and "__launch_bounds__(kThreads, kMinBlocks)" in text
    assert convolve.RESIDENT_THREADS == c["kMinBlocks"] * c["kThreads"] * convolve.H100_SMS
    assert convolve.PRODUCT_BLOCKS * convolve.PRODUCT_THREADS == convolve.PRODUCT_WAVES * convolve.RESIDENT_THREADS


@pytest.fixture
def plain_forward(monkeypatch):
    """``PackedProduct``'s forward is the kernel wrapper; on the CPU its
    plain version (bit for bit the kernel) stands in for it."""
    monkeypatch.setattr(convolve, "packed_product_kernel", convolve.convolve_accumulate_packed_plain)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("with_ab", [False, True])
@pytest.mark.parametrize("scaling", [0.25, torch.tensor(0.5)])
def test_backward_matches_autograd_through_plain(plain_forward, shared, with_ab, scaling):
    a, b = planes((3, 2, 24), 13), planes((24,) if shared else (3, 1, 24), 14)
    ab = planes((3, 2, 24), 15) if with_ab else None
    g = planes((3, 2, 24), 16)
    leaves = [tuple(t.clone().requires_grad_() for t in p) for p in (a, b) + ((ab,) if with_ab else ())]
    refs = [tuple(t.clone().requires_grad_() for t in p) for p in (a, b) + ((ab,) if with_ab else ())]
    cab = leaves[2] if with_ab else (None, None)
    out = autodiff.PackedProduct.apply(*leaves[0], *leaves[1], *cab, scaling)
    ref = convolve.convolve_accumulate_packed_plain(refs[0], refs[1], refs[2] if with_ab else None, scaling)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    (out[0] * g[0] + out[1] * g[1]).sum().backward()
    (ref[0] * g[0] + ref[1] * g[1]).sum().backward()
    for got, want in zip(leaves, refs):
        for t, r in zip(got, want):
            assert t.grad.shape == r.grad.shape
            assert float((t.grad - r.grad).abs().max()) <= 1e-6 * float(r.grad.abs().max())


def test_the_scaling_gets_no_gradient(plain_forward):
    a, b = planes((2, 8), 17), planes((8,), 18)
    al = tuple(t.clone().requires_grad_() for t in a)
    out = autodiff.PackedProduct.apply(*al, *b, None, None, torch.tensor(0.5))
    out[0].sum().backward()
    assert al[0].grad is not None and b[0].grad is None


# (outer, frames, b copied to the whole shape) the wrapper reads each of CASES as.
OPERANDS = {
    "per-stream filter (the long-IR cell's, small)": (4, 2, False),
    "shared filter": (1, 15, False),
    "shared filter with leading ones": (1, 6, False),
    "matched batch": (6, 1, False),
    "one row": (1, 1, False),
    "odd M": (3, 2, False),
    "M = 1": (5, 1, False),
    "filter broadcast over the streams": (12, 1, True),
    "filters in two leading dims": (6, 4, False),
    "a that broadcasts against b": (3, 2, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_operands_take_b_in_three_shapes(case):
    """b varying along a prefix of the leading dims is read as (outer, M)
    rows where it lies (a filter per stream, one for all, a matched batch);
    any other b is copied to the whole shape."""
    assert sorted(OPERANDS) == sorted(CASES)
    a_shape, b_shape = CASES[case]
    a, b = planes(a_shape, 1), planes(b_shape, 2)
    shape = torch.broadcast_shapes(a_shape, b_shape)
    ops, outer, inner = convolve.product_operands(shape, a, b)
    want_outer, want_inner, copied = OPERANDS[case]
    assert (outer, inner) == (want_outer, want_inner)
    assert [t.shape for t in ops] == [shape] * 2 + [shape if copied else (outer, shape[-1])] * 2
    assert all(t.is_contiguous() for t in ops)
    assert (ops[2].data_ptr() == b[0].data_ptr()) == (not copied)
    assert (ops[0].data_ptr() == a[0].data_ptr()) == (a[0].numel() == shape.numel())


def test_planes_laid_out_as_the_kernel_reads_them_are_not_copied():
    """The long-IR cell's operands (contiguous X, a contiguous filter per
    stream, a contiguous accumulator) reach the kernel where they lie;
    views are made contiguous."""
    a, b, ab = planes((4, 2, 64), 1), planes((4, 1, 64), 2), planes((4, 2, 64), 3)
    ops, _, _ = convolve.product_operands(torch.Size((4, 2, 64)), a, b, ab)
    assert [t.data_ptr() for t in ops] == [t.data_ptr() for t in (*a, *b, *ab)]
    view = tuple(t[:, 3:5] for t in planes((4, 9, 64), 4))
    ops, _, _ = convolve.product_operands(torch.Size((4, 2, 64)), view, b)
    assert ops[0].data_ptr() != view[0].data_ptr() and torch.equal(ops[0], view[0])


# ---------------------------------------------------------------------------
# A numpy model of the kernel's walk
# ---------------------------------------------------------------------------


def kernel_model(a, b, ab=None, scaling=1.0):
    """The kernel's walk in numpy float32: the wrapper's operands, width
    and geometry (``product_operands``, ``product_width``,
    ``product_geometry``), then every unit (``width`` slots of one outer
    index and a chunk of ``frames`` frames) as the kernel takes it, b
    loaded once a unit. Returns (y re, y im, b loads); an output written
    twice or never fails."""
    pairs = [a, b] + ([] if ab is None else [ab])
    shape = torch.broadcast_shapes(*(p[0].shape for p in pairs))
    m = shape[-1]
    ops, outer, inner = convolve.product_operands(shape, a, b, ab)
    assert all(t.is_contiguous() for t in ops)
    width = convolve.product_width(m, ops)
    frames, _ = convolve.product_geometry(outer, inner, m // width)
    chunks, vecs = -(-inner // frames), m // width
    s = np.float32(scaling.item() if isinstance(scaling, torch.Tensor) else scaling)
    are, aim, bre, bim, *c = (t.reshape(-1).numpy() for t in ops)
    assert bre.size == outer * m and are.size == outer * inner * m
    y = np.full((2, outer * inner * m), np.nan, np.float32)
    loads = 0
    for u in range(outer * chunks * vecs):
        slot, rest = (u % vecs) * width, u // vecs
        f0, o = (rest % chunks) * frames, rest // chunks
        br, bm = bre[o * m + slot: o * m + slot + width], bim[o * m + slot: o * m + slot + width]
        loads += 1
        for f in range(f0, min(f0 + frames, inner)):
            at = (o * inner + f) * m + slot
            xr, xm = are[at: at + width], aim[at: at + width]
            pr = xr * br - xm * bm
            pm = xr * bm + xm * br
            if slot == 0:
                pr[0], pm[0] = xr[0] * br[0], xm[0] * bm[0]
            pr, pm = pr * s, pm * s
            if c:
                pr, pm = c[0][at: at + width] + pr, c[1][at: at + width] + pm
            assert np.isnan(y[:, at: at + width]).all()
            y[0, at: at + width], y[1, at: at + width] = pr, pm
    assert not np.isnan(y).any()
    return torch.from_numpy(y[0]).reshape(shape), torch.from_numpy(y[1]).reshape(shape), loads


def _strided(shape, seed, view):
    return tuple(view(t) for t in planes(shape, seed))


# (what, a, b, ab or None): planes as the callers hand them, views included.
WALKS = {
    "per-stream filter": lambda: (planes((4, 2, 64), 1), planes((4, 1, 64), 2), None),
    "per-stream filter with ab": lambda: (planes((4, 2, 64), 1), planes((4, 1, 64), 2), planes((4, 2, 64), 3)),
    "shared filter": lambda: (planes((3, 5, 48), 4), planes((48,), 5), None),
    "matched": lambda: (planes((2, 3, 32), 6), planes((2, 3, 32), 7), planes((2, 3, 32), 8)),
    "step_k's history slice": lambda: (_strided((2, 9, 32), 9, lambda t: t[:, 3:7]), planes((2, 1, 32), 10),
                                       planes((2, 4, 32), 11)),
    "step's FDL row": lambda: (_strided((3, 5, 16), 12, lambda t: t[:, 2]), planes((3, 16), 13), None),
    "odd M": lambda: (planes((3, 2, 37), 14), planes((3, 1, 37), 15), None),
    "M = 6": lambda: (planes((3, 2, 6), 16), planes((3, 1, 6), 17), planes((3, 2, 6), 18)),
    "a float offset": lambda: (_strided((2, 3, 33), 19, lambda t: t[..., 1:]), planes((2, 1, 32), 20), None),
    "planes of different strides": lambda: ((planes((2, 3, 16), 21)[0], planes((3, 2, 16), 22)[1].transpose(0, 1)),
                                            planes((2, 1, 16), 23), None),
    "leading dims that do not fold": lambda: (planes((2, 3, 4, 20), 24), planes((2, 1, 4, 20), 25), None),
    "a slot stride of 2": lambda: (_strided((2, 3, 40), 26, lambda t: t[..., ::2]), planes((2, 1, 20), 27), None),
}


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("resident", [1, convolve.RESIDENT_THREADS])
def test_kernel_walk_matches_plain(monkeypatch, walk, resident):
    """Bit for bit: numpy float32 rounds each product, difference and sum
    as ``__fmul_rn``, ``__fsub_rn`` and ``__fadd_rn`` do. ``resident`` 1
    makes each unit walk a whole frame axis (b reused across it)."""
    monkeypatch.setattr(convolve, "RESIDENT_THREADS", resident)
    a, b, ab = WALKS[walk]()
    for scaling in (1.0, 1.0 / 3):
        yre, yim, _ = kernel_model(a, b, ab, scaling)
        want = convolve.convolve_accumulate_packed_plain(a, b, ab, scaling)
        assert torch.equal(yre, want[0]) and torch.equal(yim, want[1])


def test_the_walk_reads_a_per_stream_filter_once_a_chunk(monkeypatch):
    """At the long-IR cell's broadcast (a filter per stream over 2 frames),
    with whole frame axes as units, b is loaded once a unit: half as often
    as a."""
    monkeypatch.setattr(convolve, "RESIDENT_THREADS", 1)
    a, b = planes((4, 2, 64), 1), planes((4, 1, 64), 2)
    ops, outer, inner = convolve.product_operands(torch.Size((4, 2, 64)), a, b)
    assert (outer, inner) == (4, 2) and ops[2].shape == (4, 64)
    assert convolve.product_geometry(outer, inner, 16) == (2, 1)
    assert kernel_model(a, b)[2] == 4 * 16


def test_the_long_ir_geometry():
    """64 streams x 2 frames x 2^18 slots: 16-byte units, whole frame axes
    (4.2 M units, 31 a resident thread), 8 waves of resident blocks."""
    outer, inner, vecs = 64, 2, (1 << 18) // convolve.PRODUCT_WIDE
    assert convolve.product_geometry(outer, inner, vecs) == (2, convolve.PRODUCT_BLOCKS)
    assert convolve.PRODUCT_BLOCKS == 4224
    # a shared filter over 128 rows of 2^18: the frame axis cut into 16 chunks of 8
    frames, blocks = convolve.product_geometry(1, 128, vecs)
    assert (frames, -(-128 // frames)) == (8, 16) and blocks == 16 * vecs // convolve.PRODUCT_THREADS


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def check_against_plain(a, b, ab=None, scaling=1.0):
    before = convolve.PACKED_PRODUCT.launches
    got = convolve.convolve_accumulate_packed(a, b, ab, scaling)
    torch.cuda.synchronize()
    assert convolve.PACKED_PRODUCT.launches == before + 1
    want = convolve.convolve_accumulate_packed_plain(a, b, ab, scaling)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32 and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ab", [False, True])
@pytest.mark.parametrize("scaling", ["1/n", "a one-element tensor"])
def test_kernel_at_the_long_ir_shape(dev, with_ab, scaling):
    n = 1 << 19
    a, b = planes((64, 2, n // 2), 31, dev), planes((64, 1, n // 2), 32, dev)
    ab = planes((64, 2, n // 2), 33, dev) if with_ab else None
    check_against_plain(a, b, ab, 1.0 / n if scaling == "1/n" else torch.tensor([1.0 / n], device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("scaling", ["unit", "1/n", "1/3", "a 0-d tensor", "a (1, 1, 1, 1) float64 tensor"])
@pytest.mark.parametrize("with_ab", [False, True])
def test_kernel_matches_plain(dev, case, scaling, with_ab):
    a_shape, b_shape = CASES[case]
    a, b = planes(a_shape, 34, dev), planes(b_shape, 35, dev)
    ab = planes(torch.broadcast_shapes(a_shape, b_shape), 36, dev) if with_ab else None
    check_against_plain(a, b, ab, scaling_for(scaling, a_shape[-1]))


@pytest.mark.cuda
@pytest.mark.parametrize("walk", sorted(WALKS))
def test_kernel_takes_every_layout(dev, walk):
    a, b, ab = ([tuple(t.to(dev) for t in p) if p is not None else None for p in WALKS[walk]()])
    check_against_plain(a, b, ab, 1.0 / 3)


@pytest.mark.cuda
def test_kernel_takes_views_at_a_float_offset(dev):
    """Contiguous planes that start off 16-byte boundaries take the narrow
    accesses; strided views at an offset are copied first."""
    m = 1 << 12
    a = tuple(t[1:].view(8, 3, m) for t in planes((8 * 3 * m + 1,), 37, dev))
    b = planes((8, 1, m), 38, dev)
    ab = tuple(t[..., :-1] for t in planes((8, 3, m + 1), 39, dev))
    assert a[0].is_contiguous() and convolve.product_width(m, [a[0]]) == 1
    check_against_plain(a, b, ab, 0.5)


@pytest.mark.cuda
def test_planes_that_require_grad_under_no_grad(dev):
    """A leaf that requires grad, under ``no_grad``: the kernel on the
    detached planes, no Function and no error."""
    a, b = planes((4, 2, 1 << 10), 46, dev), planes((4, 1, 1 << 10), 47, dev)
    leaves = tuple(t.clone().requires_grad_() for t in b)
    with torch.no_grad():
        check_against_plain(a, leaves, None, 0.25)
        out = convolve.convolve_accumulate_packed(a, leaves, None, 0.25)
    assert out[0].grad_fn is None and not out[0].requires_grad
    with torch.inference_mode():
        check_against_plain(a, leaves, None, 0.25)


@pytest.mark.cuda
def test_kernel_with_the_tensor_scaling_of_the_unfused_route(dev):
    """``convolve_irfft_packed``'s unfused route at a composite size with a
    one-element tensor scaling: the kernel, read through its pointer."""
    n = 1 << 18
    a, b = planes((3, n // 2), 40, dev), planes((n // 2,), 41, dev)
    s = torch.tensor(1.0 / n, device=dev)
    before = convolve.PACKED_PRODUCT.launches
    x = api.convolve_irfft_packed(*a, *b, scaling=s, ordered=False)
    torch.cuda.synchronize()
    assert convolve.PACKED_PRODUCT.launches == before + 1
    want = api.irfft_packed_unordered(*convolve.convolve_accumulate_packed_plain(a, b, None, s))
    assert torch.equal(x, want)


# Profiles one warm long-IR call (64 x 480,000 through 96,000-tap IRs) on
# the card into a Chrome trace:
#     python -c LONGIR_PROFILE trace.json
LONGIR_PROFILE = """
import sys
import torch
from chowdsp_fft_tpu_torch import stream
from chowdsp_fft_tpu_torch.ops import convolve
from chowdsp_fft_tpu_torch.utils import profiling

gen = torch.Generator(device="cuda").manual_seed(25)
x = torch.randn(64, 480_000, generator=gen, device="cuda")
h = torch.randn(64, 96_000, generator=gen, device="cuda") / 100
stream.fir_filter_ols(x, h)  # build and warm
torch.cuda.synchronize()
before = convolve.PACKED_PRODUCT.launches
with profiling.trace(sys.argv[1]):
    stream.fir_filter_ols(x, h)
print(convolve.PACKED_PRODUCT.launches - before)
"""


@pytest.mark.cuda
def test_the_long_ir_call_runs_one_launch_and_nothing_else_under_the_product(dev, tmp_path):
    """Every device op launched inside ``ops.convolve.accumulate_packed``
    is the kernel, launched once in its launch span. The profile
    (``LONGIR_PROFILE``) runs in a process of its own."""
    proc = subprocess.run([sys.executable, "-c", LONGIR_PROFILE, str(tmp_path / "tr")], check=True, timeout=600,
                          cwd=ROOT, capture_output=True, text=True)
    assert proc.stdout.split()[-1] == "1"
    [path] = list((tmp_path / "tr").glob("trace_*.json"))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    [product] = [s for s in spans if s["name"] == "ops.convolve.accumulate_packed"]

    def inside(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"] and s.get("tid") == e.get("tid")

    [launch] = [s for s in spans if s["name"] == convolve.PACKED_PRODUCT.span]
    assert inside(launch, product)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    under = [e for e in device if inside(runtime[e["args"]["correlation"]], product)]
    assert len(under) == 1 and "packed_product_kernel" in under[0]["name"], [e["name"] for e in under]
    assert inside(runtime[under[0]["args"]["correlation"]], launch)
    ops = [e["name"] for e in events if e.get("cat") == "cpu_op" and inside(e, product)]
    assert not [op for op in ops if op in ("aten::cat", "aten::mul", "aten::sub", "aten::add")], ops


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
def test_gradients_on_the_card(dev, shared):
    a, b = planes((8, 2, 4096), 42, dev), planes((4096,) if shared else (8, 1, 4096), 43, dev)
    ab, g = planes((8, 2, 4096), 44, dev), planes((8, 2, 4096), 45, dev)
    leaves = [tuple(t.clone().requires_grad_() for t in p) for p in (a, b, ab)]
    cpu = [tuple(t.detach().cpu().requires_grad_() for t in p) for p in (a, b, ab)]
    before = convolve.PACKED_PRODUCT.launches
    out = convolve.convolve_accumulate_packed(*leaves, 1.0 / 8192)
    assert convolve.PACKED_PRODUCT.launches == before + 1
    assert type(out[0].grad_fn).__name__ == "PackedProductBackward"
    ref = convolve.convolve_accumulate_packed(*cpu, 1.0 / 8192)
    assert all(torch.equal(o.detach().cpu(), r.detach()) for o, r in zip(out, ref))
    (out[0] * g[0] + out[1] * g[1]).sum().backward()
    (ref[0] * g[0].cpu() + ref[1] * g[1].cpu()).sum().backward()
    for got, want in zip(leaves, cpu):
        for t, r in zip(got, want):
            assert float((t.grad.cpu() - r.grad).abs().max()) <= 1e-6 * float(r.grad.abs().max())
