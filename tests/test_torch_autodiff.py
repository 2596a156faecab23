"""Gradients through the port's Hopper engine (``ops/autodiff.py``): the
JAX package's seven ``custom_vjp`` rules as ``torch.autograd.Function``s.

Three ways, on the same numpy inputs:

- the port's Hopper engine against its Stockham engine, which PyTorch
  differentiates natively (``grad_match``: max abs difference over the
  reference's max below rtol 1e-4, as tests/test_autodiff.py);
- the port against ``jax.grad`` of the same JAX call on its ``pallas``
  engine (Pallas in interpret mode on the CPU), rtol 1e-4 likewise; for
  a complex input the port's gradient is the conjugate of JAX's
  (PyTorch hands back dL/dre + i dL/dim, JAX its conjugate);
- the rule itself: on a CPU tensor the Hopper engine's entries build
  their graph from the port's Functions (``grad_fn``), and the Functions'
  gradient equals native autograd of the same plain versions (rtol 1e-5
  of the largest gradient: two float32 evaluations of one linear map).

Tests ported from the JAX suite: the 7 of tests/test_autodiff.py,
test_pallas_engine.py's ``test_medium_composite_grad`` (:383),
``test_convolve_irfft_fused_grad`` (:491) and ``test_small_n_grad``
(:846), and test_fft_core.py's ``test_jit_and_grad`` (:212). On the CPU
every Function runs the kernels' plain versions; the card runs them in
tests/test_torch_cuda.py (``test_*_gradients_match_plain``, against the
same Functions on CPU copies).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu import models as jmodels
from chowdsp_fft_tpu import stream as jstream
from chowdsp_fft_tpu_torch import models, stream
from chowdsp_fft_tpu_torch.ops import autodiff, hopper_cfft
from chowdsp_fft_tpu_torch.ops import hopper_composite as hc
from chowdsp_fft_tpu_torch.ops import hopper_fft as hf

RTOL = 1e-4  # tests/test_autodiff.py's _grad_match
RULE_RTOL = 1e-5  # the Function against native autograd of the same plain ops


def np_(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


def port_grad(loss, *arrays):
    """Gradients of ``loss`` with respect to each numpy array, as tensors
    on the CPU that require grad."""
    args = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss(*args).backward()
    return [np_(a.grad) for a in args]


def grad_match(make_loss, *arrays, rtol=RTOL):
    """The Hopper engine's gradients against the Stockham engine's."""
    gh = port_grad(make_loss("hopper"), *arrays)
    gs = port_grad(make_loss("stockham"), *arrays)
    for a, b in zip(gh, gs):
        assert rel_err(a, b) < rtol
    return gh


def jax_match(port, jloss, *arrays, rtol=RTOL):
    """The port's gradients against ``jax.grad`` of the JAX loss (conj
    for complex inputs)."""
    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    for a, b, arr in zip(port, gj, arrays):
        b = np.asarray(b)
        assert rel_err(a, np.conj(b) if np.iscomplexobj(arr) else b) < rtol


def fns_in_graph(t: torch.Tensor) -> set[str]:
    """Names of every node of ``t``'s autograd graph."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return {type(n).__name__ for n in seen}


@pytest.fixture
def x():
    return np.random.default_rng(1).standard_normal((3, 512)).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_autodiff.py, ported
# ---------------------------------------------------------------------------


def test_grad_rfft_canonical(x):
    g = grad_match(lambda e: lambda v: (ct.rfft(v, engine=e).abs() ** 2).sum(), x)
    jax_match(g, lambda v: jnp.sum(jnp.abs(cf.rfft(v, engine="pallas")) ** 2), x)


def _packed_loss(re, im, lib):
    return lib.sum(re ** 2) + lib.sum(im ** 3)


def test_grad_rfft_packed(x):
    g = grad_match(lambda e: lambda v: _packed_loss(*ct.rfft_packed(v, engine=e), torch), x)
    jax_match(g, lambda v: _packed_loss(*cf.rfft_packed(v, engine="pallas"), jnp), x)


def test_grad_roundtrip_nonlinear(x):
    g = grad_match(lambda e: lambda v: torch.tanh(ct.irfft(ct.rfft(v, engine=e), engine=e) / 512.0).sum(), x)
    jax_match(g, lambda v: jnp.sum(jnp.tanh(cf.irfft(cf.rfft(v, engine="pallas"), engine="pallas") / 512.0)), x)


def test_grad_cfft_complex():
    rng = np.random.default_rng(2)
    z = (rng.standard_normal((2, 256)) + 1j * rng.standard_normal((2, 256))).astype(np.complex64)
    g = grad_match(lambda e: lambda v: (ct.fft(v, engine=e).abs() ** 2).sum(), z)
    jax_match(g, lambda v: jnp.sum(jnp.abs(cf.fft(v, engine="pallas")) ** 2), z)


def test_grad_unordered_packed_chain(x):
    """N=512 is a K1 size: the unordered layout is JAX's permutation, and
    the half-spectrum weight goes by slot."""
    def mk(e):
        def loss(v):
            re, im = ct.rfft_packed_unordered(v, engine=e)
            return torch.sin(ct.irfft_packed_unordered(re * 2.0, im * 2.0, engine=e) / 512.0).sum()
        return loss

    def jloss(v):
        re, im = cf.rfft_packed_unordered(v, engine="pallas")
        return jnp.sum(jnp.sin(cf.irfft_packed_unordered(re * 2.0, im * 2.0, engine="pallas") / 512.0))

    jax_match(grad_match(mk, x), jloss, x)


def adjoint_errors(n: int, rows: int, seed: int, engine: str = "hopper"):
    """<J v, u> against <v, J^T u> for the packed real forward and
    inverse, in float64, over the operand norms (as test_autodiff.py)."""
    rng = np.random.default_rng(seed)
    v = torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32, requires_grad=True)
    u = [torch.tensor(rng.standard_normal((rows, n // 2)), dtype=torch.float32) for _ in range(2)]
    y = ct.rfft_packed(v, engine=engine)
    jt = torch.autograd.grad(y, v, u)[0]
    y = [t.detach() for t in y]
    lhs = sum(float((a.double() * b.double()).sum()) for a, b in zip(y, u))
    rhs = float((v.detach().double() * jt.double()).sum())
    scale = float(torch.cat(y, -1).double().norm() * torch.cat(u, -1).double().norm())
    yr = [t.detach().requires_grad_() for t in y]
    yt = ct.irfft_packed(*yr, engine=engine)
    w = torch.tensor(rng.standard_normal(yt.shape), dtype=torch.float32)
    ct_re, ct_im = torch.autograd.grad(yt, yr, w)
    yt = yt.detach()
    lhs_i = float((yt.double() * w.double()).sum())
    rhs_i = float((y[0].double() * ct_re.double()).sum() + (y[1].double() * ct_im.double()).sum())
    scale_i = float(yt.double().norm() * w.double().norm())
    return abs(lhs - rhs) / scale, abs(lhs_i - rhs_i) / scale_i


def test_grad_composite_largeN_adjoint():
    """The real composite (N=2^18, K7a/K6/K7b's plain versions) under
    RfftPacked and IrfftPacked: adjoint consistency on the port alone
    (JAX's own 2^18 test runs in tests/test_autodiff.py)."""
    assert hf.rfft_packed(torch.zeros(1, 1 << 18, requires_grad=True))[0].grad_fn is not None
    fwd, inv = adjoint_errors(1 << 18, 1, 3)
    assert fwd < 1e-6 and inv < 1e-6


@pytest.mark.parametrize("n", [32768])
def test_grad_composite_matches_jax(n):
    """A composite size of the port (K1 ends at 16384) against JAX's
    single kernel at the same N, forward and inverse."""
    rng = np.random.default_rng(n)
    v = rng.standard_normal((1, n)).astype(np.float32)
    w = rng.standard_normal((1, n)).astype(np.float32)

    def loss(a, lib, fwd, inv, wv):
        re, im = fwd(a)
        return lib.sum(inv(re ** 2 / n, im) * wv)

    g = port_grad(lambda a: loss(a, torch, lambda t: ct.rfft_packed(t, engine="hopper"),
                                 lambda r, i: ct.irfft_packed(r, i, engine="hopper"), torch.from_numpy(w)), v)
    jax_match(g, lambda a: loss(a, jnp, lambda t: cf.rfft_packed(t, engine="pallas"),
                                lambda r, i: cf.irfft_packed(r, i, engine="pallas"), w), v)


def test_grad_stream_fir():
    """fir_filter_ols differentiates end to end (learned impulse
    responses): against JAX's gradient and a central difference on one
    tap (test_autodiff.py's check, 5e-2 relative)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    h0 = (rng.standard_normal(63) / 8).astype(np.float32)
    xt = torch.from_numpy(x)

    def loss(h):
        return (stream.fir_filter_ols(xt, h, block=512) ** 2).sum()

    (g,) = port_grad(loss, h0)
    jax_match([g], lambda h: jnp.sum(jstream.fir_filter_ols(jnp.asarray(x), h, block=512) ** 2), h0)
    eps = 1e-3
    e0 = np.zeros_like(h0)
    e0[7] = eps
    with torch.no_grad():
        num = (float(loss(torch.from_numpy(h0 + e0))) - float(loss(torch.from_numpy(h0 - e0)))) / (2 * eps)
    assert abs(g[7] - num) / max(abs(num), 1e-6) < 5e-2


# ---------------------------------------------------------------------------
# test_pallas_engine.py :383, :491, :846 and test_fft_core.py :212, ported
# ---------------------------------------------------------------------------


def test_medium_composite_grad():
    """N=576 on the Hopper engine runs the composite (``auto`` sends it to
    Stockham, as JAX does). Parseval's closed form: loss = sum re^2 +
    im^2 has gradient N*x + X_0 + (-1)^j X_{N/2}; bound 2e-7*N*2*max|X|
    (the backward transform of the cotangent 2*(re, im))."""
    n = 576
    x = np.random.default_rng(6).standard_normal((2, n)).astype(np.float32)
    (g,) = port_grad(lambda v: sum((t ** 2).sum() for t in ct.rfft_packed(v, engine="hopper")), x)
    spec = np.fft.rfft(x.astype(np.float64), axis=1)
    expect = n * x + spec[:, :1].real + ((-1.0) ** np.arange(n))[None, :] * spec[:, -1:].real
    assert np.abs(g - expect).max() < 2e-7 * n * 2.0 * float(np.abs(spec).max())
    jax_match([g], lambda v: sum(jnp.sum(t ** 2) for t in cf.rfft_packed(v, engine="pallas")), x)


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n,b_rows", [(256, 1), (1024, 1), (1024, 2)])
def test_convolve_irfft_fused_grad(n, b_rows, ordered):
    """The fused op's gradient (K3's Function at 1024, the unfused
    composition at the K5 size 256) against the unfused composition on
    the Stockham engine, for all four arguments, shared (1 row) and
    batched B; and against JAX's fused op."""
    rng = np.random.default_rng(n + b_rows)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.standard_normal((b_rows, n)).astype(np.float32)
    w = rng.standard_normal((2, n)).astype(np.float32)
    a = [np_(t) for t in hf.rfft_packed(torch.from_numpy(x), plan, ordered)]
    b = [np_(t) for t in hf.rfft_packed(torch.from_numpy(h), plan, ordered)]
    wt = torch.from_numpy(w)

    def fused(ar, ai, br, bi):
        y = ct.convolve_irfft_packed(ar, ai, br, bi, scaling=1.0 / n, engine="hopper", ordered=ordered)
        return (y * wt).sum()

    def unfused(ar, ai, br, bi):
        pr, pi = ct.convolve_accumulate_packed((ar, ai), (br, bi), scaling=1.0 / n)
        return (hf.irfft_packed(pr, pi, plan, ordered) * wt).sum()

    g1 = port_grad(fused, *a, *b)
    g2 = port_grad(unfused, *a, *b)
    for p, q in zip(g1, g2):
        assert np.abs(p - q).max() < 2e-7 * n
    jax_match(g1, lambda ar, ai, br, bi: jnp.sum(cf.convolve_irfft_packed(
        ar, ai, br, bi, scaling=1.0 / n, engine="pallas", ordered=ordered) * w), *a, *b)


def test_small_n_grad():
    """K5's real forward under RfftPacked (N=64)."""
    x = np.random.default_rng(7).standard_normal((3, 64)).astype(np.float32)
    g = grad_match(lambda e: lambda v: _packed_loss(*ct.rfft_packed(v, engine=e), torch), x)
    jax_match(g, lambda v: _packed_loss(*cf.rfft_packed(v, engine="pallas"), jnp), x)


def test_jit_and_grad():
    """test_fft_core.py's energy gradient at N=128 (K5 real): finite, of
    the input's shape, and Parseval's closed form. sum |X_k|^2 over the
    canonical bins k = 0..N/2 counts each paired bin once, (N*|x|^2 +
    X_0^2 + X_{N/2}^2) / 2, so its gradient is N*x + X_0 + (-1)^j X_{N/2}
    (bound 2e-7*N*2*max|X|, as test_medium_composite_grad)."""
    n = 128
    x = np.random.default_rng(8).standard_normal((n,)).astype(np.float32)
    (g,) = port_grad(lambda v: (ct.rfft(v).abs() ** 2).sum(), x)
    assert g.shape == x.shape and np.isfinite(g).all()
    spec = np.fft.rfft(x.astype(np.float64))
    expect = n * x + spec[0].real + ((-1.0) ** np.arange(n)) * spec[-1].real
    assert np.abs(g - expect).max() < 2e-7 * n * 2.0 * float(np.abs(spec).max())
    jax_match([g], lambda v: jnp.sum(jnp.abs(cf.rfft(v)) ** 2), x)


# ---------------------------------------------------------------------------
# The rule itself: the Functions are the graph, and equal native autograd
# of the plain ops
# ---------------------------------------------------------------------------


def test_hopper_grad_fn_is_the_function():
    v = torch.randn(2, 1024, requires_grad=True)
    re, im = ct.rfft_packed(v, engine="hopper")
    assert "RfftPackedBackward" in fns_in_graph(re)
    assert "IrfftPackedBackward" in fns_in_graph(ct.irfft_packed(re, im, engine="hopper"))
    y = ct.convolve_irfft_packed(re, im, re[:1], im[:1], scaling=0.5, engine="hopper")
    assert "ConvolveIrfftPackedBackward" in fns_in_graph(y)
    z = torch.randn(2, 1024, dtype=torch.complex64, requires_grad=True)
    assert "CfftPairBackward" in fns_in_graph(ct.fft(z, engine="hopper"))
    assert "CfftPairBackward" in fns_in_graph(ct.ifft_planes(z.real, z.imag, engine="hopper")[0])
    # The Stockham engine stays natively differentiated; without grad the
    # entries build no graph.
    assert not any(name.startswith(("Rfft", "Cfft")) for name in fns_in_graph(ct.rfft_packed(v, engine="stockham")[0]))
    with torch.no_grad():
        assert ct.rfft_packed(v, engine="hopper")[0].grad_fn is None
    assert ct.rfft_packed(v.detach(), engine="hopper")[0].grad_fn is None


def _native(fn, *arrays, w):
    """Native autograd of ``fn`` (plain ops) on the arrays, loss sum(out * w)."""
    return port_grad(lambda *a: sum((o * wi).sum() for o, wi in zip(_tup(fn(*a)), w)), *arrays)


def _tup(t):
    return t if isinstance(t, tuple) else (t,)


def _real_cotangents(rng, n, rows, inverse):
    shape = [(rows, n)] if inverse else [(rows, n // 2)] * 2
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32) for s in shape]


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n", [64, 480, 1024, 1920, 32768])
def test_real_rules_equal_native_autograd(n, ordered):
    """RfftPacked and IrfftPacked (K5 at 64 and 480, K1/K2 at 1024 and
    1920, the composite at 32768) against native autograd of the same
    plain versions."""
    rng = np.random.default_rng(n)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    x = rng.standard_normal((3, n)).astype(np.float32)
    w = _real_cotangents(rng, n, 3, False)
    got = _native(lambda v: autodiff.RfftPacked.apply(v, plan, ordered), x, w=w)
    want = _native(lambda v: hf.rfft_rows(v, plan, ordered), x, w=w)
    assert rel_err(got[0], want[0]) < RULE_RTOL
    spec = [np_(t) for t in hf.rfft_rows(torch.from_numpy(x), plan, ordered)]
    w = _real_cotangents(rng, n, 3, True)
    got = _native(lambda a, b: autodiff.IrfftPacked.apply(a, b, plan, ordered), *spec, w=w)
    want = _native(lambda a, b: hf.irfft_rows(a, b, plan, ordered), *spec, w=w)
    for p, q in zip(got, want):
        assert rel_err(p, q) < RULE_RTOL


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("b_rows", [1, 3])
def test_convolve_rule_equals_native_autograd(b_rows, ordered):
    n = 2048
    rng = np.random.default_rng(b_rows)
    plan = ct.cached_plan(n, ct.FFT_REAL)
    a = [rng.standard_normal((3, n // 2)).astype(np.float32) for _ in range(2)]
    b = [rng.standard_normal((b_rows, n // 2)).astype(np.float32) for _ in range(2)]
    w = [torch.tensor(rng.standard_normal((3, n)), dtype=torch.float32)]
    got = _native(lambda *t: autodiff.ConvolveIrfftPacked.apply(*t, plan, 0.25, ordered), *a, *b, w=w)
    want = _native(lambda *t: hf.convolve_irfft_packed_plain(*t, 0.25, plan, ordered), *a, *b, w=w)
    for p, q in zip(got, want):
        assert p.shape == q.shape and rel_err(p, q) < RULE_RTOL


@pytest.mark.parametrize("planes", [True, False])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_cfft_rule_equals_native_autograd(n, ordered, forward, planes):
    """CfftPair (K5 at 64, K4 at 1024 in both orders, the composite at
    16384) on planes and complex64 against native autograd of the plain
    versions; on planes the gradients are the complex gradient's parts."""
    rng = np.random.default_rng(n + 2 * ordered + forward)
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    re, im = (rng.standard_normal((2, n)).astype(np.float32) for _ in range(2))
    wr, wi = (torch.tensor(rng.standard_normal((2, n)), dtype=torch.float32) for _ in range(2))
    if planes:
        def rule(a, b):
            return autodiff.CfftPair.apply(a, b, plan, forward, ordered)

        def plain(a, b):
            return hc.cfft_rows((a, b), plan, forward, ordered)

        got = _native(rule, re, im, w=[wr, wi])
        want = _native(plain, re, im, w=[wr, wi])
    else:
        def loss(y):
            return (y.real * wr + y.imag * wi).sum()

        z = (re + 1j * im).astype(np.complex64)
        got = port_grad(lambda a: loss(autodiff.CfftPair.apply(a, None, plan, forward, ordered)), z)
        want = port_grad(lambda a: loss(hc.cfft_rows(a, plan, forward, ordered)), z)
        planes_grad = _native(lambda a, b: autodiff.CfftPair.apply(a, b, plan, forward, ordered),
                              re, im, w=[wr, wi])
        np.testing.assert_array_equal(got[0], planes_grad[0] + 1j * planes_grad[1])
    for p, q in zip(got, want):
        assert rel_err(p, q) < RULE_RTOL


def test_halfspec_weight_goes_by_slot():
    re, im = torch.ones(2, 8), torch.full((2, 8), 3.0)
    sre, sim = autodiff.halfspec_weight(re, im, 0.5)
    assert sre[:, 0].eq(1).all() and sim[:, 0].eq(3).all()
    assert sre[:, 1:].eq(0.5).all() and sim[:, 1:].eq(1.5).all()
    assert re.eq(1).all() and im.eq(3).all()  # inputs untouched


def test_double_backward_raises():
    v = torch.randn(2, 1024, requires_grad=True)
    re, _ = ct.rfft_packed(v, engine="hopper")
    (g,) = torch.autograd.grad((re ** 2).sum(), v, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_entries_resolve_lazy_conjugates():
    """A conjugate view's memory holds the unconjugated values: the
    entries materialize it before a kernel reads the memory, and the
    kernel wrappers refuse one."""
    z = torch.randn(2, 1024, dtype=torch.complex64)
    assert not hf._rows(z.conj(), 1024, torch.complex64).is_conj()
    with pytest.raises(ValueError, match="conjugate"):
        hf._check("z", z.conj(), (2, 1024), z.device, torch.complex64)
    plan = ct.cached_plan(1024, ct.FFT_COMPLEX)
    torch.testing.assert_close(ct.fft(z.conj(), engine="hopper"), hopper_cfft.cfft_plain(z.conj().resolve_conj(), plan))


# ---------------------------------------------------------------------------
# The layers above: gradients through the stream and model layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_channel", [False, True])
def test_grad_fir_filter_ols_x_and_h(per_channel):
    """A shared (taps,) filter (K1 + K3's Function) and per-channel
    filters (K1 + the packed product + K2's Function), gradients to x and
    h, against the Stockham engine and JAX."""
    rng = np.random.default_rng(9 + per_channel)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    h = (rng.standard_normal((2, 200) if per_channel else 200) / 16).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    wt = torch.from_numpy(w)
    g = grad_match(lambda e: lambda a, b: (stream.fir_filter_ols(a, b, block=800, engine=e) * wt).sum(), x, h)
    jax_match(g, lambda a, b: jnp.sum(jstream.fir_filter_ols(a, b, block=800) * w), x, h)


def test_grad_partitioned_fir_x_and_h():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    h = (rng.standard_normal(1500) / 32).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    wt = torch.from_numpy(w)
    g = grad_match(lambda e: lambda a, b: (stream.partitioned_fir_apply(a, b, block=512, engine=e) * wt).sum(),
                   x, h)
    jax_match(g, lambda a, b: jnp.sum(jstream.partitioned_fir_apply(a, b, block=512) * w), x, h)
    # The offline form of a built filter: gradient to x.
    fir = stream.PartitionedFIR(torch.from_numpy(h), block=512)
    (gx,) = port_grad(lambda a: (fir.apply_offline(a) * wt).sum(), x)
    np.testing.assert_allclose(gx, g[0], rtol=0, atol=RULE_RTOL * np.abs(g[0]).max())


def test_grad_convolver_apply_x():
    rng = np.random.default_rng(12)
    ir = (rng.standard_normal((3, 700)) / 32).astype(np.float32)
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    wt = torch.from_numpy(w)
    cfg = models.ConvolverConfig(channels=3, block=256)

    def mk(e):
        conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=3, block=256, engine=e), device="cpu")
        return lambda a: (conv.apply(a) * wt).sum()

    g = grad_match(mk, x)
    jconv = jmodels.MultichannelConvolver(jnp.asarray(ir), jmodels.ConvolverConfig(channels=3, block=cfg.block))
    jax_match(g, lambda a: jnp.sum(jconv.apply(a) * w), x)


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (1024, 256)])
def test_grad_stft_istft_spectrogram(n_fft, hop):
    """Gradients to x through stft (K1's Function, ordered), istft (K2's,
    with its overlap-add of slice adds into one tensor) and spectrogram,
    against the Stockham engine and JAX."""
    rng = np.random.default_rng(n_fft + hop)
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    frames = -(-(4000 + n_fft - hop) // hop)
    ws = rng.standard_normal((2, frames, n_fft // 2 + 1)).astype(np.float32)

    def fit(s):
        return ws[:, : s.shape[-2]]

    def mk(e):
        def loss(a):
            s = stream.stft(a, n_fft=n_fft, hop=hop, engine=e)
            y = stream.istft(s * s.abs(), hop=hop, length=4000, engine=e)
            p = stream.spectrogram(a, n_fft=n_fft, hop=hop, engine=e)
            return (y ** 2).sum() + (p * torch.from_numpy(fit(p))).sum() / n_fft
        return loss

    def jloss(a):
        s = jstream.stft(a, n_fft=n_fft, hop=hop)
        y = jstream.istft(s * jnp.abs(s), hop=hop, length=4000)
        p = jstream.spectrogram(a, n_fft=n_fft, hop=hop)
        return jnp.sum(y ** 2) + jnp.sum(p * fit(p)) / n_fft

    jax_match(grad_match(mk, x), jloss, x)
