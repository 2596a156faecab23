"""Plan persistence and the informational surface of the port: the JAX
package's save/load, plan_bytes and merge_precision tests case for case,
plans that cross between the packages in both directions bit-exactly,
and the port's tables against the JAX plan's."""

import jax
import numpy as np
import pytest
import torch

import chowdsp_fft_tpu as cf
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu import plans as jax_plans
from chowdsp_fft_tpu.utils import native as jax_native
from chowdsp_fft_tpu_torch import plans
from chowdsp_fft_tpu_torch.ops import hopper_fft
from chowdsp_fft_tpu_torch.utils import native
from torch_parity import np_, tol

# The sizes of test_torch_tables.py's test_kernel_tables_match_jax, and 2^20.
SIZES = [384, 640, 1024, 1920, 4096, 16384, 1 << 20]


def leaves(plan) -> list[np.ndarray]:
    """A port plan's tables in the JAX plan's pytree order."""
    out = [t for st in plan.stages for t in (st.tw_re, st.tw_im)]
    return out + ([plan.rfft_tw_re, plan.rfft_tw_im] if plan.rfft_tw_re is not None else [])


# -- tests/test_fft_core.py and test_pallas_engine.py, case for case --------


def test_plan_save_load_roundtrip(tmp_path, rng):
    p = ct.make_plan(768, ct.FFT_REAL)
    path = str(tmp_path / "plan.npz")
    plans.save_plan(p, path)
    q = plans.load_plan(path)
    assert q.n == p.n and q.kind == p.kind and q.radices == p.radices
    assert [(s.radix, s.m, s.s) for s in q.stages] == [(s.radix, s.m, s.s) for s in p.stages]
    for a, b in zip(leaves(p), leaves(q), strict=True):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert q._on_device == {}  # no device copy before first use
    # a loaded plan drives a transform, bit-equal to a fresh plan's
    x = torch.from_numpy(rng.standard_normal((3, 768)).astype(np.float32))
    got = ct.rfft(x, plan=q)
    assert torch.equal(got, ct.rfft(x, plan=p))
    ref = np.fft.rfft(np_(x).astype(np.float64), axis=-1)
    assert np.abs(np_(got) - ref).max() < tol(768)


def test_plan_save_load_without_npz_suffix(tmp_path):
    p = ct.make_plan(512, ct.FFT_COMPLEX)
    path = str(tmp_path / "plan_no_suffix")
    plans.save_plan(p, path)
    assert (tmp_path / "plan_no_suffix.npz").exists()
    q = plans.load_plan(path)
    assert q.n == p.n and q.kind == p.kind


def test_plan_bytes_positive():
    assert ct.plan_bytes(4096, ct.FFT_REAL) > 0
    assert ct.vector_width_bytes() == 128  # one warp's 32 float32 lanes (JAX: 512, a VPU row)


def test_merge_precision_knob(rng):
    """The mode is carried by the ambient float32 matmul precision and
    restored on exit; the Hopper engine's FP32 butterflies ignore it, so
    bf16x3 gives the same output, within the reference bound."""
    n = 1024
    x = torch.from_numpy(rng.standard_normal((4, n)).astype(np.float32))
    ref = np.fft.rfft(np_(x).astype(np.float64), axis=-1)
    re_hi, _ = ct.rfft_packed(x, engine="hopper")
    assert hopper_fft._merge_mode() == "highest"
    with ct.merge_precision("bf16x3"):
        assert hopper_fft._merge_mode() == "bf16x3"
        assert torch.get_float32_matmul_precision() == "high"
        re_lo, _ = ct.rfft_packed(x, engine="hopper")
    assert hopper_fft._merge_mode() == "highest"  # restored
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.equal(re_hi, re_lo)
    assert np.abs(np_(re_lo)[:, 1:] - ref[:, 1 : n // 2].real).max() < tol(n)
    with pytest.raises(ValueError, match="merge precision"):
        with ct.merge_precision("fp8"):
            pass


# -- the mode carrier ---------------------------------------------------------


def test_merge_precision_restores_the_callers_setting():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        assert hopper_fft._merge_mode() == "bf16x3"  # an ambient bf16-grade precision selects it
        with ct.merge_precision("highest"):
            assert hopper_fft._merge_mode() == "highest"
        assert torch.get_float32_matmul_precision() == "medium"
        with pytest.raises(RuntimeError, match="inside"):
            with ct.merge_precision("bf16x3"):
                assert torch.get_float32_matmul_precision() == "high"
                raise RuntimeError("inside")
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_merge_mode_refuses_an_unknown_carrier(monkeypatch):
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "tf32")
    with pytest.raises(ValueError, match="merge precision"):
        hopper_fft._merge_mode()


# -- across the packages ------------------------------------------------------


@pytest.mark.parametrize("n,kind", [(768, "real"), (2, "real"), (4096, "real"), (480, "complex"),
                                    (1 << 20, "real"), (1 << 20, "complex")])
def test_jax_saved_plan_loads_in_the_port(tmp_path, n, kind):
    ref = cf.make_plan(n, kind)
    jax_plans.save_plan(ref, str(tmp_path / "jax"))
    mine = plans.load_plan(tmp_path / "jax.npz")
    assert (mine.n, mine.kind, mine.radices) == (ref.n, ref.kind, tuple(ref.radices))
    for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(ref), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n,kind", [(768, "real"), (2, "real"), (4096, "real"), (480, "complex"),
                                    (1 << 20, "real"), (1 << 20, "complex")])
def test_port_saved_plan_loads_in_jax(tmp_path, n, kind):
    mine = ct.make_plan(n, kind)
    plans.save_plan(mine, tmp_path / "port")
    ref = jax_plans.load_plan(str(tmp_path / "port"))
    assert (ref.n, ref.kind, tuple(ref.radices)) == (mine.n, mine.kind, mine.radices)
    for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(ref), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_load_plan_checks_the_tables(tmp_path):
    p = ct.make_plan(1024, ct.FFT_REAL)
    bad = leaves(p)
    bad[0] = bad[0][:, :-1]
    np.savez(tmp_path / "bad.npz", n=1024, kind="real", **{f"leaf{i}": a for i, a in enumerate(bad)})
    with pytest.raises(ValueError, match="shape"):
        plans.load_plan(tmp_path / "bad.npz")
    np.savez(tmp_path / "odd.npz", n=7 * 128, kind="real")
    with pytest.raises(ct.InvalidSizeError):
        plans.load_plan(tmp_path / "odd")


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_plan_bytes_match_jax(kind):
    for n in SIZES:
        assert ct.plan_bytes(n, kind) == cf.plan_bytes(n, kind), (n, kind)


@pytest.mark.parametrize("n,kind", [(n, k) for n in SIZES for k in ("real", "complex")])
def test_tables_bit_equal_to_jax_plan(n, kind):
    """Where the JAX package's planner loaded, its plans hold the planner's
    tables; where the port's did too, the two plans' tables are bit-equal
    (one source). Otherwise a side holds numpy's, within one float32 ulp
    of 1 of the other's."""
    mine, ref = ct.make_plan(n, kind), cf.make_plan(n, kind)
    exact = native.available() and jax_native.get_lib() is not None
    for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(ref), strict=True):
        if exact:
            np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_allclose(a, np.asarray(b), atol=2.0**-24, rtol=0)
