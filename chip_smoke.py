"""Drive the PyTorch port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repo checkout (the kernels are built
from ``chowdsp_fft_tpu_torch/csrc`` into ``build/hopper/`` on first use).
Phases, each of which asserts:

1. identify the card (name and power limit) and build the kernels;
2. run K1-K3 against their plain PyTorch twins on the card and against
   float64 numpy on the host, bound 2e-7*N (max abs error);
3. BASELINE config 3 end to end: a 4096-tap FIR on 4 x 2^20-sample
   streams through ``stream.fir_filter_ols(block=8192)`` and
   ``stream.partitioned_fir_apply(block=1024)``, against a float64 FFT
   convolution (atol 5e-4 and 1e-3), plus ``PartitionedFIR.step_k``
   streaming against the offline result;
4. the kernels carried the path: every launch count from phase 3 > 0, and
   ``engine_for`` picks the Hopper engine at the path's sizes;
5. timing at N=4096, B=1024 (kernel, plain twin, cuFFT), informational.

The line before the last is the kernel report as JSON; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero on any failure and when
no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 2e-7  # times N: the JAX package's bound against float64
HEADLINE = (4096, 1024)  # (N, rows): bench.py's shape
CONFIG3 = {"streams": 4, "samples": 1 << 20, "taps": 4096}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against twins and float64
# ---------------------------------------------------------------------------


def packed_ref(x64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 packed planes (ordered) of real rows."""
    n = x64.shape[-1]
    spec = np.fft.rfft(x64, axis=-1)
    re = spec[..., : n // 2].real.copy()
    im = spec[..., : n // 2].imag.copy()
    im[..., 0] = spec[..., n // 2].real
    return re, im


def check_kernels(hf, tables, dev, rng, n: int, rows: int) -> dict[str, float]:
    """Max abs errors of K1-K3 (kernel vs twin, kernel vs float64) at one
    shape, both orders; asserts each is within TOL*N."""
    import chowdsp_fft_tpu_torch as ct

    plan = ct.cached_plan(n, ct.FFT_REAL)
    perm = tables.unordered_perm(n)
    bound = TOL * n
    x = rng.standard_normal((rows, n))
    h = rng.standard_normal((rows, n)) / np.sqrt(n)
    ref_re, ref_im = packed_ref(x)
    hre64, him64 = packed_ref(h)
    # irfft(scale * X (.) H) with scale = 1/N is the circular convolution.
    conv64 = np.fft.irfft(np.fft.rfft(x) * np.fft.rfft(h), n=n)
    errs: dict[str, float] = {}

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def note(key: str, got: torch.Tensor, want, scale: float = 1.0):
        """Record max|got*scale - want|; a tensor ``want`` (a twin's
        output) is scaled like ``got``."""
        if isinstance(want, torch.Tensor):
            want = want.double().cpu().numpy() * scale
        err = float(np.abs(got.double().cpu().numpy() * scale - want).max()) if got.numel() else 0.0
        errs[key] = err
        require(err <= bound, f"N={n} rows={rows} {key}: max abs err {err:.3e} > {bound:.3e}")

    for ordered in (True, False):
        tag = "ord" if ordered else "unord"
        sel = slice(None) if ordered else perm
        xt = on_dev(x)
        yre, yim = hf.rfft_packed_kernel(xt, plan, ordered)
        pre, pim = hf.rfft_packed_plain(xt, plan, ordered)
        note(f"k1_{tag}_twin", torch.cat([yre, yim], -1), torch.cat([pre, pim], -1))
        note(f"k1_{tag}_f64", torch.cat([yre, yim], -1),
             np.concatenate([ref_re[:, sel], ref_im[:, sel]], -1))

        sre = on_dev(ref_re[:, sel])
        sim = on_dev(ref_im[:, sel])
        xk = hf.irfft_packed_kernel(sre, sim, plan, ordered)
        note(f"k2_{tag}_twin", xk, hf.irfft_packed_plain(sre, sim, plan, ordered), 1.0 / n)
        note(f"k2_{tag}_f64", xk, x, 1.0 / n)

        hre = on_dev(hre64[:, sel])
        him = on_dev(him64[:, sel])
        for shared in (False, True):
            btag = "shared" if shared else "batched"
            b_re, b_im = (hre[:1], him[:1]) if shared else (hre, him)
            want = (np.fft.irfft(np.fft.rfft(x) * np.fft.rfft(h[:1]), n=n) if shared else conv64)
            yk = hf.convolve_irfft_packed_kernel(sre, sim, b_re, b_im, 1.0 / n, plan, ordered)
            yp = hf.convolve_irfft_packed_plain(sre, sim, b_re, b_im, 1.0 / n, plan, ordered)
            note(f"k3_{tag}_{btag}_twin", yk, yp)
            note(f"k3_{tag}_{btag}_f64", yk, want)
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# Phase 3: BASELINE config 3
# ---------------------------------------------------------------------------


def fft_convolve64(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    t, taps = x.shape[-1], h.shape[-1]
    nfft = 1 << (t + taps - 2).bit_length()
    y = np.fft.irfft(np.fft.rfft(x, nfft) * np.fft.rfft(h, nfft), nfft)
    return y[..., :t]


# ---------------------------------------------------------------------------
# Phase 5: timing
# ---------------------------------------------------------------------------


def time_ms(fn, args_list, iters: int = 20, rounds: int = 7, gap_s: float = 0.05) -> float:
    """Median over spaced rounds of the mean time per call (CUDA events);
    the calls rotate over ``args_list`` so inputs are not L2-resident."""
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        time.sleep(gap_s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    import chowdsp_fft_tpu_torch as ct
    from chowdsp_fft_tpu_torch import stream
    from chowdsp_fft_tpu_torch.ops import _cuda, hopper_fft as hf, tables

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)

    # -- phase 1 ------------------------------------------------------------
    card = card_line()
    log(card)  # the nvidia-smi line as it is: name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    max_n = _cuda.library().hopper_real_fft_max_n()
    require(max_n == hf.MAX_N, f"kernel MAX_N {max_n} != hopper_fft.MAX_N {hf.MAX_N}")
    log(f"phase 1 ok: kernels built in {time.perf_counter() - t0:.2f} s -> {lib_path}")

    # -- phase 2 ------------------------------------------------------------
    shapes = [HEADLINE, (4096, 1), (4096, 1023), (512, 64), (2048, 256),
              (16384, 64), (384, 7), (640, 5), (1920, 3)]
    headline_err: dict[str, float] = {}
    for n, rows in shapes:
        errs = check_kernels(hf, tables, dev, rng, n, rows)
        worst = max(errs.values())
        log(f"phase 2 N={n} rows={rows}: worst max abs err {worst:.3e} (bound {TOL * n:.3e})")
        if (n, rows) == HEADLINE:
            headline_err = errs
            for k, v in sorted(errs.items()):
                log(f"  {k}: {v:.3e}")
    log("phase 2 ok")

    # -- phase 3 ------------------------------------------------------------
    s, t, taps = CONFIG3["streams"], CONFIG3["samples"], CONFIG3["taps"]
    x64 = rng.standard_normal((s, t))
    h64 = rng.standard_normal(taps) / np.sqrt(taps)
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    h = torch.from_numpy(h64.astype(np.float32)).to(dev)
    hf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_ols = stream.fir_filter_ols(x, h, block=8192)
    y_pfir = stream.partitioned_fir_apply(x, h, block=1024)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS}
    log(f"phase 3 main path ran in {wall:.3f} s (first call, host clock); launches {launches}")
    ref = fft_convolve64(x64.astype(np.float32).astype(np.float64), h64.astype(np.float32).astype(np.float64))
    for name, y, atol in (("fir_filter_ols", y_ols, 5e-4), ("partitioned_fir_apply", y_pfir, 1e-3)):
        require(tuple(y.shape) == (s, t), f"{name}: shape {tuple(y.shape)}")
        require(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
        err = float(np.abs(y.double().cpu().numpy() - ref).max())
        log(f"phase 3 {name}: max abs err vs float64 {err:.3e} (atol {atol})")
        require(err <= atol, f"{name}: {err} > {atol}")
    fir = stream.PartitionedFIR(h, block=1024)
    state = fir.init_state((s,))
    k_blocks, chunks = 16, 4
    outs = []
    for c in range(chunks):
        xb = x[:, c * k_blocks * 1024 : (c + 1) * k_blocks * 1024].reshape(s, k_blocks, 1024)
        state, yk = fir.step_k(state, xb)
        outs.append(yk.reshape(s, -1))
    y_stream = torch.cat(outs, -1)
    err = float((y_stream - y_pfir[:, : y_stream.shape[-1]]).abs().max())
    log(f"phase 3 step_k x{chunks} (K={k_blocks}) vs offline: max abs err {err:.3e}")
    require(err <= 1e-5, f"step_k streaming disagrees with offline: {err}")
    log("phase 3 ok")

    # -- phase 4 ------------------------------------------------------------
    for k in hf.KERNELS:
        require(launches[k.name] > 0, f"{k.name} was not launched on the main path")
    for n in (2048, 4096, 16384):
        require(ct.engine_for(n, "real") == "hopper", f"engine_for({n}) = {ct.engine_for(n, 'real')}")
    log("phase 4 ok: every kernel carried the path")

    # -- phase 5 ------------------------------------------------------------
    n, rows = HEADLINE
    plan = ct.cached_plan(n, ct.FFT_REAL)
    xs = [torch.randn(rows, n, device=dev) for _ in range(4)]
    specs = [hf.rfft_packed_kernel(xi, plan, False) for xi in xs]
    filt = specs[0][0][:1].clone(), specs[0][1][:1].clone()
    timing = {
        "rfft_packed_kernel": (
            time_ms(lambda a: hf.rfft_packed_kernel(a, plan, False), [(a,) for a in xs]),
            time_ms(lambda a: hf.rfft_packed_plain(a, plan, False), [(a,) for a in xs]),
        ),
        "irfft_packed_kernel": (
            time_ms(lambda r, i: hf.irfft_packed_kernel(r, i, plan, False), specs),
            time_ms(lambda r, i: hf.irfft_packed_plain(r, i, plan, False), specs),
        ),
        "convolve_irfft_packed_kernel": (
            time_ms(lambda r, i: hf.convolve_irfft_packed_kernel(r, i, *filt, 1.0 / n, plan, False), specs),
            time_ms(lambda r, i: hf.convolve_irfft_packed_plain(r, i, *filt, 1.0 / n, plan, False), specs),
        ),
    }
    cufft_r = time_ms(lambda a: torch.fft.rfft(a), [(a,) for a in xs])
    cspecs = [(torch.fft.rfft(a),) for a in xs]
    cufft_i = time_ms(lambda c: torch.fft.irfft(c, n=n), cspecs)
    for name, (k_ms, p_ms) in timing.items():
        log(f"phase 5 {name} N={n} B={rows}: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms [{card}]")
    log(f"phase 5 torch.fft.rfft (cuFFT) N={n} B={rows}: {cufft_r:.4f} ms; "
        f"torch.fft.irfft: {cufft_i:.4f} ms [{card}]")

    kernels = []
    for k in hf.KERNELS:
        prefix = {"rfft_packed_kernel": "k1", "irfft_packed_kernel": "k2",
                  "convolve_irfft_packed_kernel": "k3"}[k.name]
        err = max(v for key, v in headline_err.items() if key.startswith(prefix) and key.endswith("twin"))
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "max_abs_err": err,
            "ms": timing[k.name][0], "plain_ms": timing[k.name][1],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    result = {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
