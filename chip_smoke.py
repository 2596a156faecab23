"""Drive the PyTorch port once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc``, ``g++`` and the repo checkout (the kernels
are built from ``chowdsp_fft_tpu_torch/csrc`` into ``build/hopper/`` on
first use, the native planner from ``native/planner.cpp`` into
``build/native/``).
Phases, each of which asserts:

1. identify the card (name and power limit), build the kernels (one nvcc
   per source, in parallel), check the size limits (MAX_N, MAX_CN,
   MAX_SMALL_N, MAX_COL) and K5's and the K1-K4 row engine's points per
   thread against Python's, report ptxas's registers and spills of the
   row engine's kernels (K1-K4, K1-db, K2-db, K4-db) and of the column
   engine's (K6's four roles, K7a, K7b);
2. run K1-K3 against their plain PyTorch versions on the card and against
   float64 numpy on the host, bound 2e-7*N (max abs error); K1 at every
   size of its domain (36 N) at 1, 7 and 1001 rows, both orders, planes,
   joint rows and 8-byte aligned views; a zeroed K1 output and one
   without its Nyquist slot must fail the check; K2 and K3 likewise at
   every size (36 N) at 1, 7 and 1001 rows, both orders, K3 with a shared
   and a batched B, 8-byte aligned views bit-equal; a zeroed output and an
   input without its Nyquist bins must fail;
3. BASELINE config 3 end to end: a 4096-tap FIR on 4 x 2^20-sample
   streams through ``stream.fir_filter_ols(block=8192)`` and
   ``stream.partitioned_fir_apply(block=1024)``, against a float64 FFT
   convolution (atol 5e-4 and 1e-3), plus ``PartitionedFIR.step_k``
   streaming against the offline result;
4. K1-K3 and the offline FDL's partitioned accumulate carried config 3:
   every launch count from phase 3 > 0, and ``engine_for`` picks the
   Hopper engine at the path's sizes;
5. timing at N=4096, B=1024 (kernel, plain version, cuFFT), informational,
   with K1-K3's launch geometry and resident blocks per SM;
6. K4 and K5 against their plain versions and float64, bound 2e-7*N:
   K4 forward/backward x ordered/unordered, planes and complex64, at
   every size of its domain (33 N) at 1, 7 and 1001 rows (8-byte aligned
   views bit-equal) and its path shapes, a zeroed output failing; K5 at
   every size of its domain (60 complex N, 47 real), at 1, T-1, T+1 and
   2001 rows (T its tile of rows) and at config 5's 32768 rows of 256,
   forward and backward, planes (bit-equal to complex64), real forward and
   inverse; a zeroed output and a real forward without its Nyquist slot
   must fail the check;
7. BASELINE config 5 at its published width: ``models.SDRChain`` (256
   channels) on one 2^24-sample capture of FM carriers plus noise,
   against float64 definitions (scipy ``upfirdn`` decimators, the
   channelizer's mixer definition): channelizer output, the occupied
   channels' audio, each carrier's power in its channel; K5 and two
   launches of the polyphase decimator carried it;
8. a K4 path: ``stream.channelize`` with C = 1024 on the same capture,
   against the mixer definition and against the same channelizer on K4's
   plain version (every bin, 2e-7*C of the peak); K4 carried it;
9. a K5-real path: ``PartitionedFIR(h, block=128)`` on config 3's streams
   (N = 256), ``step_k`` against ``partitioned_fir_apply`` and float64;
   both real K5 bodies carried it;
10. coverage: every kernel record (``hopper_fft.KERNELS``,
    ``convolve.KERNELS`` and ``polyphase.KERNELS``) launched on its path, ``engine_for`` at the
    complex, small and composite sizes;
11. timing (informational): K4 at N=4096, B=1024 against ``torch.fft.fft``,
    K5 at N=256, B=32768 against ``torch.fft.ifft`` / ``rfft`` / ``irfft``
    (inverses unscaled, ``norm="forward"``, as the kernels are), each
    kernel's plain version, K4's and K5's launch geometry and resident
    blocks per SM;
    the config-5 chain and ``partitioned_fir_apply(block=128)`` on config
    3's streams (the K5-real path): wall time per call, device time by
    kernel (``torch.profiler``) and idle share;
12. the composite kernels (K6 in its four roles, K7a, K7b) against their
    plain versions and the composites against float64, bound 2e-7*N
    (or 2e-7*L times the output's rms where smaller, L the kernel's own
    length: ``held``):
    complex N from 16384 to 2^20, real N from 32768 to 2^20, odd and even
    batches, planes and complex64; a zeroed K7b output and K7b without
    its Nyquist slot must fail the check; then K6's four roles (complex64
    and planes), K7a and K7b on their own at every column length the
    composite's splits produce (``hopper_composite.column_lengths``: 71
    complex lengths, 51 real), 3 rows of a ragged 37 columns, K7a also
    against float64; a zeroed K7a output and one without its Nyquist
    slot must fail the check;
13. BASELINE config 2's top row: ``fft``/``ifft``/``rfft_packed``/
    ``irfft_packed`` with ``engine="auto"`` at N=2^20, B=64, every row
    against the plain composite, 4 rows against float64; each composite
    kernel carried it;
14. a convolution reverb: ``stream.fir_filter_ols`` of 64 channels x 10 s
    at 48 kHz with per-channel 2 s impulse responses (N = 2^19), 8
    channels against a float64 FFT convolution and all 64 against the
    same call on the Stockham engine; K7a, K6 level 2 and its reverse,
    K7b and the line transforms' K4 carried it;
15. timing (informational): each composite kernel at config 2's top row
    against its plain version, its bound (``utils/roofline.py``) and the
    matching ``torch.fft`` call, with the column engine's launch geometry
    and resident blocks per SM there; K6 level 2 and its reverse on the
    real composite's planes; K7a at the reverb's shape; the whole
    transforms, and the reverb's wall and device time per call;
16. BASELINE config 4 as examples/02_convolution_reverb.py deploys it:
    ``models.MultichannelConvolver`` built from the numpy IR bank (64
    channels, 2 s IRs) on its default device, ``apply`` on 64 x 10 s at
    48 kHz (block 4096: N = 8192, P = 24), 8 channels against a float64
    FFT convolution (atol 1e-3), all 64 against the model on the Stockham
    engine, then ``init_state`` and 8 ``step`` calls against the offline
    output (atol 1e-4); K1, K2 and one launch of the partitioned
    accumulate carried it;
17. the STFT on the same audio (n_fft 1024, hop 512): ``spectrogram``,
    ``stft`` -> ``istft`` (round trip, atol 1e-4), 4 channels' frames
    against float64 (2e-7*n_fft*4); K1 and K2 carried it;
18. the pipelined kernels K1-db, K2-db, K4-db: ``torch.equal`` to K1
    (joint), K2, K4 at the headline shape, N = 16384, 9216 and MAX_CN,
    the C = 1024 channelizer's batch, ragged batches, a single row and
    config 4's own frames and accumulated spectra (recorded on phase 16's
    path; K1-db and K2-db reproduce the model's outputs), K2-db also at
    every size of phase 2's sweep, and within 2e-7*N of their plain
    versions; a zeroed output must fail. Then their
    own run, counted: config 4's frames and spectra through K1-db and
    K2-db, the channelizer's transform through K4-db;
19. timing (informational): each db kernel beside its grid kernel
    (grid/db/db/grid in turn) at every shape of phase 18, plain versions
    at the headline shape; K1 at config 4's 7552 x 8192 frames and the
    STFT's 60,096 x 1024, K2 on config 4's accumulated spectra and at
    config 3's block 1024 (4096 x 2048), K3 at config 3's fir_filter_ols
    (512 x 16384, a shared filter), K4 backward at the channelizer's
    16384 x 1024, each beside its ``torch.fft`` call (K3 beside the
    inverse alone) and bound, with the launch geometry
    and resident blocks per SM; config 4's ``apply`` (wall, device time by
    kernel, idle share) and one ``step``, and ``spectrogram``.

20. gradients on the card (``ops/autodiff.py``): each autograd Function
    against the same Function on the plain versions (2e-7*N times the
    cotangent's largest value), against float64 (the adjoint identity,
    relative 1e-6; the slot-0 closed forms, relative 1e-5; Parseval's
    closed form for RfftPacked) and by the kernels its backward launched:
    RfftPacked and IrfftPacked at N=4096, B=1024 (both orders), N=256,
    B=32768 (K5), N=576 and N=2^20, B=64 (the composite);
    ConvolveIrfftPacked at config 3's 512 x 16384 with a shared and a
    batched B; CfftPair at 4096 x 1024 (K4), 256 x 32768 (K5) and 2^20 x
    64 (K6's four roles), both directions, planes and complex64. A zeroed
    gradient and a half weight applied to slot 0 must fail. Then the
    training slice: an impulse response learned with Adam from zero on
    config 3's streams (5 steps; K1 + K3 forward, K1 + K2 backward) and on
    the reverb (3 steps; the composite both ways), the loss falling at
    every step, the first gradient against the Stockham engine and float64
    (2e-7*N of its largest value), each step's wall, device time by kernel
    and backward/forward ratio; and config 4's ``apply`` differentiated
    with respect to x, 8 channels against the Stockham engine.
21. the parallel layer (``chowdsp_fft_tpu_torch/parallel``) on a one-rank
    NCCL group, a ``dsp_mesh(1)`` on the card: its collectives are copies
    (the halo hop has no operations), so the exchange between cards is
    not shown, only the sharded paths' local work. Config 3's
    ``sharded_fir_ols(block=8192)`` and ``sharded_partitioned_fir(block=1024)``
    against phase 3's float64 reference (atol 5e-4, 1e-3); config 4's
    ``time_sharded_apply`` and ``channel_sharded_apply`` at full width
    against ``apply`` (1e-4); config 5's ``SDRChain.sharded_step`` on phase
    7's capture against ``chain(capture)`` (1e-4 on the occupied channels);
    the distributed FFT (complex and real, forward and inverse) at config
    2's top row (N=2^20, B=64) against float64 on the card and at N=2^24,
    B=2 against numpy float64 on the host, through ``spectrum_order`` and
    ``rspectrum_order`` (2e-7*N; a zeroed output and a real spectrum
    without its DC/Nyquist slots must fail), and ``sharded_rfft_convolve``
    / ``sharded_fft_convolve`` against float64 convolutions; K1-K5 carried
    the paths. Timing (informational): ``sharded_fft_planes`` beside
    ``ct.fft`` and cuFFT at N=2^20, B=64 with the all_to_all's share, each
    sharded form's wall beside its unsharded call, and the halo model's
    prediction for config 4 (a model on NVLink's data-sheet rate).
    The partitioned accumulate carried config 3's and config 4's paths.
22. the last modules of the port, through the kernels: the native planner
    built from ``native/planner.cpp`` into ``build/native/`` and the
    plans' tables (real 4096, 256 and 2^20, complex 256 and 2^20)
    bit-equal to its float64 tables cast to float32; plans saved and
    loaded (``plans.save_plan``/``load_plan``) driving K1 (ordered, 4096 x
    1024), K5 (256 x 32768, complex and real), K7a and K7b (2^20 x 64)
    with output ``torch.equal`` to a fresh plan's, and a loaded plan with
    one split twiddle changed changing K1's output;
    ``merge_precision("bf16x3")``: K1, K2, K3 (config 3's 512 x 16384, a
    shared filter), K4 and K5 ``torch.equal`` to "highest", the ambient
    float32 matmul precision restored; the numpy adapter's
    fft/ifft/rfft/irfft at 4096 x 1024 and 2^20 x 64, an ``axis=0``, an
    ``n=`` and a host-array case, and ``JuceStyleFFT`` at every order
    5..20 on 8 rows and order 12 on 1024 (``perform`` both ways, both
    real-only transforms, the frequency-only transform), all against
    float64 on the card (2e-7*N; a zeroed output fails), each on the
    kernels its size dispatches to (K5 to order 8; complex: K4 9-13, K6
    14-20; real: K1/K2 9-14, K7a/K7b with K6 level 2 15-20);
    ``profiling.op_seconds`` of ``rfft_packed_unordered`` at the headline
    within 0.8-1.25x of phase 5's graph device time of K1, and
    ``profiling.trace`` writing a Chrome trace that names K1's kernel;
    then (informational) graph-replay device totals (``op_seconds``) of
    ``spectrogram`` (its work with the window on the card), ``istft``'s
    irfft and config 4's ``step``, beside ``torch.profiler``'s totals.
23. the offline FDL's kernel (``ops/convolve.convolve_accumulate_partitioned``,
    ``csrc/partitioned_accumulate.cu``) against its plain version on the
    same card tensors, max abs error within 1e-5 of the plain output's
    rms: at the reverb's 64 x 118 x 4096 with P = 24 (a filter per
    stream), config 3's 4 x 1024 x 1024 at block 1024 (P = 4, shared),
    one stream of 938 blocks the wrapper splits into runs (P = 24) and
    P = 80 (passes of 32, shared); one launch a call; a zeroed output and
    a filter without its last partition must fail. Then (informational)
    ptxas's registers of each sub-ring count, and at each shape the
    kernel's time beside its plain version's and its bound (X and H read
    once, Y written once).
24. the polyphase decimator (``ops/polyphase.decimate_kernel``,
    ``csrc/polyphase.cu``) against its plain version (framed cuDNN
    convolutions) on the same card tensors, max abs error within 1e-5 of
    the plain output's rms: at config 5's front end (2 x 2^24, f = 2, 64
    taps) on I and Q planes and on the interleaved capture (a sample
    stride of 2), its audio filter (256 x 32768, f = 4, 64 taps) on
    contiguous rows and channel-fastest (a sample stride of 256), odd
    rows that start off 16-byte boundaries and the domain's corner (f =
    16, 1024 taps); the library's limits against Python's; one launch a
    call; a zeroed output and a filter without its last tap must fail.
    Then (informational) ptxas's registers, and at the chain's shapes the
    kernel's time beside its plain version's, cuDNN's strided ``conv1d``
    on the unframed rows (the yardstick, ``library_ms``) and its bound (x
    read once, y written once), with the gap to the bound.

Every kernel time is taken twice (phases 5, 11, 15, 19, 23, 24): ``ms``, CUDA
events around 20 calls from Python (host-inclusive: the wrapper, ctypes
and the launch), and ``device_ms``, the same 20 calls captured in one CUDA
graph and replayed (``graph_time_ms``: no host in the loop); the matching
``torch.fft`` call likewise (``library_ms``, ``library_device_ms``).

Phases run in the order 1-9, 12-14, 16-18, 20, 21, 22, 23, 24, 10, 11, 15,
19. The line before the last is the kernel report as JSON, one entry for
each record of ``hopper_fft.KERNELS``, ``convolve.KERNELS`` and
``polyphase.KERNELS`` (with each kernel's
launches in phase 20's backward passes, ``backward_launches``, on phase
21's parallel paths, ``parallel_launches``, and on phase 22's paths,
``adapter_launches``); the last line is ``{"ok": true,
"device": {...}}``. Exits non-zero on any failure and when no CUDA device is
present.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 2e-7  # times N: the JAX package's bound against float64
HEADLINE = (4096, 1024)  # (N, rows): bench.py's shape
CONFIG3 = {"streams": 4, "samples": 1 << 20, "taps": 4096}
CONFIG5_SAMPLES = 1 << 24  # 0.67 s of IQ at 25 MS/s
CARRIERS = (3, 17, 40, 61, 90, 170, 215, 250)  # occupied channels of the 256-channel bank
EMPTY = (0, 10, 29, 128, 200, 240)  # channels with noise only
CHANNEL_RTOL = 5e-5  # channelizer max error / reference peak (test_stream.py: 1e-4)
AUDIO_ATOL = 1e-5  # occupied channels' demod and audio (radians per sample), max abs error
AUDIO_SKIP = 32  # audio samples of filter transient (test_parallel.py drops 32)
SMALL_TIMED = (256, 32768)  # K5 at config 5's channelizer shape
SMALL_ROWS = 2001  # phase 6's many-row case at every K5 size
K4_PATH = (1024, CONFIG5_SAMPLES // 1024)  # K4 at phase 8's channelizer shape
DOMAIN_ROWS = (1, 7, 1001)  # K1 and K4 at every size of their domains: one, an odd and a large batch


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started (where the
    run's time goes, against its time limit)."""
    print(f"[{time.perf_counter() - _START:6.1f} s] {msg}", flush=True)


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


def view8(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a tensor whose data lies 8 bytes past a 16-byte
    boundary (the JAX functions take any array: the kernels take 8-byte
    aligned views)."""
    words = t.numel() * t.element_size() // 4
    flat = torch.empty(words + 4, dtype=torch.float32, device=t.device)
    base = (16 - flat.data_ptr() % 16) % 16 // 4 + 2
    v = flat[base : base + words].view(t.dtype).reshape(t.shape)
    v.copy_(t)
    require(v.data_ptr() % 16 == 8, "view8: not 8 bytes off a 16-byte boundary")
    return v


def k1_domain(ct, hf, tables, dev, rng) -> tuple[float, dict[str, float]]:
    """K1 at every size of its domain, at 1, DOMAIN_ROWS[1] and
    DOMAIN_ROWS[2] rows, both orders: planes and the joint form (also on
    an 8-byte aligned view, bit-equal) within 2e-7*N of the plain version
    and of float64. A zeroed output and one without its Nyquist slot must
    fail the same check. Returns the worst error against the plain
    version and how far each broken output fails (error / bound)."""
    worst, caught = 0.0, {}
    sizes = [n for n in range(257, hf.MAX_N + 1) if hf._in_domain(n)]
    for n in sizes:
        plan = ct.cached_plan(n, ct.FFT_REAL)
        m, bound = n // 2, TOL * n
        for rows in (1, *DOMAIN_ROWS[1:]):
            x64 = rng.standard_normal((rows, n)).astype(np.float32).astype(np.float64)
            x = torch.from_numpy(x64.astype(np.float32)).to(dev)
            ref_re, ref_im = packed_ref(x64)
            for ordered in (True, False):
                sel = slice(None) if ordered else tables.unordered_perm(n)
                want = np.concatenate([ref_re[:, sel], ref_im[:, sel]], -1)
                y = torch.cat(hf.rfft_packed_kernel(x, plan, ordered), -1)
                plain = torch.cat(hf.rfft_packed_plain(x, plan, ordered), -1)
                e_plain, e64 = max_err(y, plain), max_err(y, want)
                worst = max(worst, e_plain)
                require(max(e_plain, e64) <= bound, f"K1 N={n} rows={rows} ordered={ordered}: {e_plain:.3e} vs "
                        f"plain, {e64:.3e} vs float64 > {bound:.3e}")
                require(torch.equal(hf.rfft_packed_joint_kernel(x, plan, ordered), y),
                        f"K1 N={n} rows={rows}: joint rows differ from the planes")
                require(torch.equal(hf.rfft_packed_joint_kernel(view8(x), plan, ordered), y),
                        f"K1 N={n} rows={rows}: the 8-byte aligned view differs")
                if rows == DOMAIN_ROWS[-1]:
                    bad = y.clone()
                    bad[:, m] = 0  # im[0]: the Nyquist bin
                    for tag, out in (("zeroed K1", torch.zeros_like(y)), ("K1 without its Nyquist slot", bad)):
                        err = max_err(out, want)
                        require(err > bound, f"{tag} N={n}: the check passes a broken output ({err:.3e})")
                        caught[tag] = min(caught.get(tag, np.inf), err / bound)
    torch.cuda.synchronize()
    log(f"phase 2 K1: all {len(sizes)} sizes N={sizes[0]}..{sizes[-1]} at 1, {DOMAIN_ROWS[1]} and {DOMAIN_ROWS[2]} "
        f"rows, both orders, planes, joint and 8-byte aligned views: within 2e-7*N of the plain version and "
        f"float64 (worst vs plain {worst:.3e}); a broken output fails by at least "
        + ", ".join(f"{r:.0f}x its bound ({tag})" for tag, r in caught.items()))
    return worst, caught


def k2_k3_domain(ct, hf, tables, dev, rng) -> tuple[dict[str, float], dict[str, float]]:
    """K2 and K3 at every size of their domain, at 1, DOMAIN_ROWS[1] and
    DOMAIN_ROWS[2] rows, both orders: K2 on the float64 packed spectra of
    unit-scale rows (out / N against the rows), K3 on the same spectra
    with a shared and a batched B (scale 1/N: against the float64 circular
    convolution), each within 2e-7*N of its plain version and of float64,
    and bit-equal on 8-byte aligned views. A zeroed output and an input
    without its Nyquist bins must fail the same check. Returns each
    kernel's worst error against its plain version and how far each
    broken output fails (error / bound)."""
    worst = {hf.K2.name: 0.0, hf.K3.name: 0.0}
    caught: dict[str, float] = {}
    sizes = [n for n in range(257, hf.MAX_N + 1) if hf._in_domain(n)]

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    for n in sizes:
        plan = ct.cached_plan(n, ct.FFT_REAL)
        bound = TOL * n
        for rows in (1, *DOMAIN_ROWS[1:]):
            x64 = rng.standard_normal((rows, n)).astype(np.float32).astype(np.float64)
            h64 = (rng.standard_normal((rows, n)) / np.sqrt(n)).astype(np.float32).astype(np.float64)
            ref_re, ref_im = packed_ref(x64)
            h_re, h_im = packed_ref(h64)
            xt = on_dev(x64)
            x_spec = np.fft.rfft(x64)
            wants = {b_rows: torch.from_numpy(np.fft.irfft(x_spec * np.fft.rfft(h64[:b_rows]), n=n)).to(dev)
                     for b_rows in (1, rows)}
            for ordered in (True, False):
                sel = slice(None) if ordered else tables.unordered_perm(n)
                tag = f"N={n} rows={rows} ordered={ordered}"
                re, im = on_dev(ref_re[:, sel]), on_dev(ref_im[:, sel])
                back = hf.irfft_packed_kernel(re, im, plan, ordered)
                e_plain = max_err(back / n, hf.irfft_packed_plain(re, im, plan, ordered) / n)
                e64 = max_err(back / n, xt)
                worst[hf.K2.name] = max(worst[hf.K2.name], e_plain)
                require(max(e_plain, e64) <= bound, f"K2 {tag}: {e_plain:.3e} vs plain, {e64:.3e} vs float64 > "
                        f"{bound:.3e}")
                require(torch.equal(hf.irfft_packed_kernel(view8(re), view8(im), plan, ordered), back),
                        f"K2 {tag}: the 8-byte aligned view differs")
                if rows == DOMAIN_ROWS[-1]:
                    no_nyq = im.clone()
                    no_nyq[:, 0] = 0  # im[0]: the Nyquist bin, position 0 in both layouts
                    for key, out in (("zeroed K2", torch.zeros_like(back)),
                                     ("K2 without its Nyquist bins", hf.irfft_packed_kernel(re, no_nyq, plan, ordered))):
                        err = max_err(out / n, xt)
                        require(err > bound, f"{key} {tag}: the check passes a broken output ({err:.3e})")
                        caught[key] = min(caught.get(key, np.inf), err / bound)
                hre, him = on_dev(h_re[:, sel]), on_dev(h_im[:, sel])
                for b_rows in (1, rows):
                    b = (hre[:b_rows].contiguous(), him[:b_rows].contiguous())
                    want = wants[b_rows]
                    y = hf.convolve_irfft_packed_kernel(re, im, *b, 1.0 / n, plan, ordered)
                    e_plain = max_err(y, hf.convolve_irfft_packed_plain(re, im, *b, 1.0 / n, plan, ordered))
                    e64 = max_err(y, want)
                    worst[hf.K3.name] = max(worst[hf.K3.name], e_plain)
                    require(max(e_plain, e64) <= bound, f"K3 {tag} B rows={b_rows}: {e_plain:.3e} vs plain, "
                            f"{e64:.3e} vs float64 > {bound:.3e}")
                    require(torch.equal(hf.convolve_irfft_packed_kernel(view8(re), view8(im), *map(view8, b),
                                                                        1.0 / n, plan, ordered), y),
                            f"K3 {tag} B rows={b_rows}: the 8-byte aligned views differ")
                    if rows == DOMAIN_ROWS[-1] and b_rows == 1:
                        err = max_err(torch.zeros_like(y), want)
                        require(err > bound, f"zeroed K3 {tag}: the check passes a broken output ({err:.3e})")
                        caught["zeroed K3"] = min(caught.get("zeroed K3", np.inf), err / bound)
    torch.cuda.synchronize()
    log(f"phase 2 K2, K3: all {len(sizes)} sizes N={sizes[0]}..{sizes[-1]} at 1, {DOMAIN_ROWS[1]} and "
        f"{DOMAIN_ROWS[2]} rows, both orders, K3 with a shared and a batched B, 8-byte aligned views: within "
        f"2e-7*N of the plain versions and float64 (worst vs plain "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + "); a broken output fails by at least "
        + ", ".join(f"{r:.0f}x its bound ({tag})" for tag, r in caught.items()))
    return worst, caught


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


def graph_time_ms(fn, args_list, iters: int = 20, rounds: int = 7, gap_s: float = 0.05) -> float:
    """Device time per call: ``iters`` calls (rotating over ``args_list``)
    captured in one CUDA graph on a side stream, replayed in spaced rounds
    timed with CUDA events; the median over rounds of the mean per call.
    No host work runs between the launches, so the wrappers' Python and
    ctypes cost does not show. A capture that fails raises: there is no
    fallback to :func:`time_ms`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: plans, tables, cuFFT plans
        for a in args_list:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        time.sleep(gap_s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(per_call)


def both_ms(fn, args_list) -> tuple[float, float]:
    """(host-inclusive ms per call, device ms per call by graph replay)."""
    return time_ms(fn, args_list), graph_time_ms(fn, args_list)


def kernel_times(fn, plain, args_list, library=None, library_args=None) -> dict:
    """A kernel's row of the report at one shape: its host-inclusive and
    device ms, its plain version's host-inclusive ms, and the same two
    times of the PyTorch call that computes the same function (None where
    there is none), on ``library_args`` (default: the kernel's)."""
    ms, device_ms = both_ms(fn, args_list)
    lib_ms = lib_device_ms = None
    if library is not None:
        lib_ms, lib_device_ms = both_ms(library, library_args or args_list)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": time_ms(plain, args_list),
            "library_ms": lib_ms, "library_device_ms": lib_device_ms}


def log_times(phase: int, name: str, shape: str, t: dict, card: str) -> None:
    lib = ("none" if t["library_ms"] is None
           else f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f} ms)")
    log(f"phase {phase} {name} {shape}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), plain "
        f"{t['plain_ms']:.4f} ms, library {lib} [{card}]")


def wall_ms(fn, reps: int) -> float:
    """Median host-clock time per call of ``fn``, each call ending in
    ``synchronize``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def breakdown(phase: int, name: str, fn, wall: float, card: str, top: int = 10) -> dict[str, float]:
    """Log the wall, the device time by kernel of one call (profiler) and
    the idle share; returns the device time by kernel name."""
    by_kernel = kernel_device_times(fn)
    device_ms = sum(by_kernel.values())
    log(f"phase {phase} {name}: wall {wall:.3f} ms per call (median, host clock), device {device_ms:.3f} ms, "
        f"idle share {1 - device_ms / wall:.3f} [{card}]")
    for kname, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms:9.4f} ms  {kname[:110]}")
    return by_kernel


# ---------------------------------------------------------------------------
# Phase 6: K4 and K5 against their plain versions and float64
# ---------------------------------------------------------------------------


def crandn(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def max_err(got, want) -> float:
    """Max abs difference of two complex or real arrays/tensors, in float64
    (complex128) on ``got``'s device when it is a tensor."""
    if not isinstance(got, torch.Tensor):
        want = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) else want
        return float(np.abs(np.asarray(got, np.complex128) - want).max()) if np.size(got) else 0.0
    if not got.numel():
        return 0.0
    w = want if isinstance(want, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(want))
    cplx = got.is_complex() or w.is_complex()
    dt = torch.complex128 if cplx else torch.float64
    return float((got.to(dt) - w.to(got.device, dt)).abs().max())


def phase6(ct, hopper_cfft, hopper_small, tables, dev, rng) -> dict[str, float]:
    """Returns each K4/K5 kernel's worst max abs error against its plain
    version (outputs of a backward transform divided by N)."""
    worst = {k.name: 0.0 for k in (hopper_cfft.K4, hopper_small.K5_COMPLEX,
                                   hopper_small.K5_REAL, hopper_small.K5_REAL_INVERSE)}

    def note(kernel, key, err, bound):
        if key.endswith("plain"):
            worst[kernel.name] = max(worst[kernel.name], err)
        require(err <= bound, f"{kernel.name} {key}: max abs err {err:.3e} > {bound:.3e}")

    def complex_case(kernel, fn, plain, n, rows, orders, views=False):
        plan = ct.cached_plan(n, ct.FFT_COMPLEX)
        bound = TOL * n
        z = crandn(rng, (rows, n))
        spec64 = np.fft.fft(z.astype(np.complex128), axis=-1)
        for ordered in orders:
            sel = slice(None) if ordered else tables.cfft_unordered_perm(n)
            for forward in (True, False):
                src = z if forward else spec64[:, sel].astype(np.complex64)
                want = spec64[:, sel] if forward else z.astype(np.complex128)
                scale = 1.0 if forward else 1.0 / n
                zt = torch.from_numpy(np.ascontiguousarray(src)).to(dev)
                y = fn(zt, plan, forward, ordered)
                p = plain(zt, plan, forward, ordered)
                tag = f"N={n} rows={rows} {'fwd' if forward else 'bwd'} {'ord' if ordered else 'unord'}"
                note(kernel, f"{tag} plain", max_err(y * scale, p * scale), bound)
                note(kernel, f"{tag} f64", max_err(y * scale, want), bound)
                planes = (zt.real.contiguous(), zt.imag.contiguous())
                yr, yi = fn(planes, plan, forward, ordered)
                note(kernel, f"{tag} planes == complex64", max_err(torch.complex(yr, yi), y), 0.0)
                if views:
                    note(kernel, f"{tag} 8-byte view == aligned", max_err(fn(view8(zt), plan, forward, ordered), y), 0.0)

    k4_shapes = ((4096, 1024), (384, 7), (640, 5), (1920, 3), (8192, 64), (hopper_cfft.MAX_CN, 8),
                 K4_PATH)
    for n, rows in k4_shapes:
        complex_case(hopper_cfft.K4, hopper_cfft.cfft_kernel, hopper_cfft.cfft_plain, n, rows, (True, False))
    # K4 at every size of its domain, one, an odd and a large batch.
    k4_sizes = [n for n in range(257, hopper_cfft.MAX_CN + 1) if hopper_cfft.in_domain(n)]
    for n in k4_sizes:
        for rows in DOMAIN_ROWS:
            complex_case(hopper_cfft.K4, hopper_cfft.cfft_kernel, hopper_cfft.cfft_plain, n, rows, (True, False),
                         views=True)
    log(f"phase 6 K4: worst max abs err vs plain {worst[hopper_cfft.K4.name]:.3e} (all {len(k4_sizes)} sizes "
        f"N={k4_sizes[0]}..{k4_sizes[-1]} at {DOMAIN_ROWS} rows, both directions and orders, complex64, planes and "
        "8-byte aligned views, and the path shapes)")

    def small_c(z, plan, forward, ordered):
        return hopper_small.small_cfft_kernel(z, plan, forward)

    def small_c_plain(z, plan, forward, ordered):
        return hopper_small.small_cfft_plain(z, plan, forward)

    caught: dict[str, float] = {}

    def fails(tag, bad, want, bound):
        """The check can fail: ``bad`` (a broken output) must be out of
        bound where the kernel's output was in."""
        err = max_err(bad, want)
        require(err > bound, f"{tag}: the check passes a broken output ({err:.3e} <= {bound:.3e})")
        caught[tag] = min(caught.get(tag, np.inf), err / bound)

    def real_case(n, rows, broken):
        plan = ct.cached_plan(n, ct.FFT_REAL)
        bound = TOL * n
        x64 = rng.standard_normal((rows, n)).astype(np.float32).astype(np.float64)
        xt = torch.from_numpy(x64.astype(np.float32)).to(dev)
        re, im = hopper_small.small_rfft_kernel(xt, plan)
        pre, pim = hopper_small.small_rfft_plain(xt, plan)
        ref_re, ref_im = packed_ref(x64)
        tag = f"real N={n} rows={rows}"
        note(hopper_small.K5_REAL, f"{tag} plain", max(max_err(re, pre), max_err(im, pim)), bound)
        note(hopper_small.K5_REAL, f"{tag} f64", max(max_err(re, ref_re), max_err(im, ref_im)), bound)
        sre = torch.from_numpy(ref_re.astype(np.float32)).to(dev)
        sim = torch.from_numpy(ref_im.astype(np.float32)).to(dev)
        back = hopper_small.small_irfft_kernel(sre, sim, plan)
        pback = hopper_small.small_irfft_plain(sre, sim, plan)
        note(hopper_small.K5_REAL_INVERSE, f"{tag} plain", max_err(back / n, pback / n), bound)
        note(hopper_small.K5_REAL_INVERSE, f"{tag} f64", max_err(back / n, x64), bound)
        if broken:
            no_nyq = im.clone()
            no_nyq[:, 0] = 0
            fails("real forward without its Nyquist slot", no_nyq, ref_im, bound)
            fails("zeroed real forward", torch.zeros_like(re), ref_re, bound)
            fails("zeroed real inverse", torch.zeros_like(back), x64, bound)

    # Every size of K5's domain, complex and (even N) real, at 1, T-1, T+1
    # and SMALL_ROWS rows (T the kernel's tile of rows at that size; T-1
    # is 0 where T = 1), forward and backward, planes and complex64; and
    # config 5's shape.
    sizes = [n for n in range(hopper_small.MIN_SMALL, hopper_small.MAX_SMALL_N + 1)
             if hopper_small.in_domain(n) and ct.is_valid_size(n)]
    for n in sizes:
        for kind in ("complex", "real") if n % 2 == 0 else ("complex",):
            tile = hopper_small.launch_geometry(n, kind, 1).tile_rows
            for rows in (1, tile - 1, tile + 1, SMALL_ROWS):
                if kind == "complex":
                    complex_case(hopper_small.K5_COMPLEX, small_c, small_c_plain, n, rows, (True,))
                else:
                    real_case(n, rows, rows == SMALL_ROWS)
        z = crandn(rng, (SMALL_ROWS, n))
        fails("zeroed complex forward", np.zeros_like(z), np.fft.fft(z.astype(np.complex128), axis=-1), TOL * n)
    for n in k4_sizes:
        z = crandn(rng, (DOMAIN_ROWS[-1], n))
        fails("zeroed K4 forward", np.zeros_like(z), np.fft.fft(z.astype(np.complex128), axis=-1), TOL * n)
    complex_case(hopper_small.K5_COMPLEX, small_c, small_c_plain, *SMALL_TIMED, (True,))
    real_case(*SMALL_TIMED, True)
    torch.cuda.synchronize()
    log(f"phase 6 K5: {len(sizes)} complex and {sum(n % 2 == 0 for n in sizes)} real sizes, N={sizes[0]}..{sizes[-1]}, "
        f"at 1, T-1, T+1 and {SMALL_ROWS} rows and N={SMALL_TIMED[0]} at {SMALL_TIMED[1]}: within 2e-7*N of the "
        "plain versions and float64; a broken output fails by at least "
        + ", ".join(f"{r:.0f}x its bound ({tag})" for tag, r in caught.items()))
    log("phase 6 ok: K4, K5 within 2e-7*N of their plain versions and float64; "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


# ---------------------------------------------------------------------------
# Phases 7-8: BASELINE config 5 and the K4 channelizer, against float64
# ---------------------------------------------------------------------------


def make_capture(rng) -> np.ndarray:
    """2^24 complex64 IQ samples: an FM carrier at the centre of each
    occupied channel of the 256-channel bank (after the 2x front end),
    each with its own tone, plus complex noise."""
    t = CONFIG5_SAMPLES
    n = np.arange(t, dtype=np.float64)
    iq = 0.01 * (rng.standard_normal(t) + 1j * rng.standard_normal(t))
    for i, ch in enumerate(CARRIERS):
        f = (ch if ch < 128 else ch - 256) / 512.0  # cycles per wideband sample
        tone = np.sin(2 * np.pi * (0.0005 + 0.0002 * i) * n)
        phase = 2 * np.pi * f * n + 2 * np.pi * (0.1 / 512.0) * np.cumsum(tone)
        iq += np.exp(1j * phase) / np.sqrt(len(CARRIERS))
    return iq.astype(np.complex64)


def mixer_reference(z64: np.ndarray, proto64: np.ndarray, channels: int, ch: int, steps: int) -> np.ndarray:
    """Channel ``ch`` by definition (test_stream.py): mix down, prototype
    low-pass, keep samples m*C + C-1, gain 1/C and the commutator phase.
    (h * x)[m*C + C-1] == upfirdn(h, [0, x], 1, C)[m + 1]."""
    from scipy.signal import upfirdn

    mixed = z64 * np.exp(-2j * np.pi * ch * (np.arange(z64.size) % channels) / channels)
    filt = upfirdn(proto64, np.concatenate([[0.0], mixed]), 1, channels)[1 : steps + 1]
    return filt * np.exp(2j * np.pi * ch * (channels - 1) / channels) / channels


def check_channels(name: str, got: torch.Tensor, z64: np.ndarray, proto64: np.ndarray, chans) -> float:
    c, steps = got.shape[-2], got.shape[-1]
    worst = 0.0
    for ch in chans:
        ref = mixer_reference(z64, proto64, c, ch, steps)
        err = max_err(got[ch], ref) / float(np.abs(ref).max())
        worst = max(worst, err)
        require(err < CHANNEL_RTOL, f"{name} channel {ch}: max err / peak {err:.3e} >= {CHANNEL_RTOL}")
    log(f"{name}: channels {list(chans)} max err / reference peak {worst:.3e} (bound {CHANNEL_RTOL})")
    return worst


def phase7(hf, models, stream, dev, capture: np.ndarray) -> dict[str, int]:
    from scipy.signal import upfirdn
    from chowdsp_fft_tpu_torch.ops import polyphase

    cfg = models.SDRChainConfig()
    require(cfg.channels == 256, "config 5 is the 256-channel chain")
    chain = models.SDRChain(cfg, device=dev)
    iq = torch.from_numpy(capture).to(dev)
    hf.reset_launch_counts()
    polyphase.DECIMATE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = chain(iq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS + polyphase.KERNELS}
    require(launches[polyphase.DECIMATE.name] == 2, f"config 5 launched the decimator "
            f"{launches[polyphase.DECIMATE.name]} times, not once for each of its two decimators")
    steps = CONFIG5_SAMPLES // (cfg.decimation * cfg.channels)
    want_shape = (cfg.channels, steps // cfg.audio_decimation)
    log(f"phase 7 config 5 (SDRChain, C=256, 2^24 samples) ran in {wall:.3f} s (first call, host clock); "
        f"launches {launches}")
    require(tuple(audio.shape) == want_shape and audio.dtype == torch.float32, f"audio {tuple(audio.shape)}")
    require(bool(torch.isfinite(audio).all()), "non-finite audio")

    # float64 references from the definitions, on the chain's own filters
    front = chain.front_lp.double().cpu().numpy()
    audio_lp = chain.audio_lp.double().cpu().numpy()
    proto = stream.design_lowpass(cfg.channels * cfg.channel_taps_per_branch, 1.0 / cfg.channels, device="cpu")
    proto64 = proto.double().numpy()
    z64 = upfirdn(front, capture.astype(np.complex128), 1, cfg.decimation)[: CONFIG5_SAMPLES // cfg.decimation]
    bank = chain.channelizer(chain.front_end(iq))
    check_channels("phase 7 channelizer (C=256)", bank, z64, proto64, CARRIERS + EMPTY)

    power = (bank.abs() ** 2).mean(-1).cpu().numpy()
    quiet = np.delete(power, [c + d for c in CARRIERS for d in (-1, 0, 1) if 0 <= c + d < cfg.channels])
    for ch in CARRIERS:
        require(power[ch] > 100 * quiet.max(), f"carrier {ch}: power {power[ch]:.3e} vs quiet {quiet.max():.3e}")
    log(f"phase 7 carriers: power in own channel / loudest quiet channel >= "
        f"{min(power[ch] for ch in CARRIERS) / quiet.max():.1f}")

    # The filter transient at the start puts phase steps near +-pi, where
    # atan2 may land on either side: the demod is compared as wrapped
    # phase differences, the audio after its transient (as test_parallel.py).
    demod_err = audio_err = 0.0
    for ch in CARRIERS:
        ref = mixer_reference(z64, proto64, cfg.channels, ch, steps)
        d = np.zeros(steps)
        d[1:] = np.angle(ref[1:] * np.conj(ref[:-1])) * cfg.fm_gain
        got = stream.fm_demod(bank[ch], gain=cfg.fm_gain).double().cpu().numpy()
        # (sample 0 has no phase history: atan2 of signed zeros, as in the JAX package)
        demod_err = max(demod_err, float(np.abs(np.angle(np.exp(1j * (got[1:] - d[1:])))).max()))
        ref_audio = upfirdn(audio_lp, d, 1, cfg.audio_decimation)[: steps // cfg.audio_decimation]
        audio_err = max(audio_err, max_err(audio[ch, AUDIO_SKIP:], ref_audio[AUDIO_SKIP:]))
    log(f"phase 7 occupied channels: demod max wrapped err {demod_err:.3e}; audio (after "
        f"{AUDIO_SKIP} samples) max abs err vs float64 {audio_err:.3e} (atol {AUDIO_ATOL})")
    require(demod_err <= AUDIO_ATOL and audio_err <= AUDIO_ATOL, f"demod/audio error > {AUDIO_ATOL}")
    log("phase 7 ok")
    return launches


def phase8(hf, stream, dev, capture: np.ndarray) -> dict[str, int]:
    channels = K4_PATH[0]
    iq = torch.from_numpy(capture).to(dev)
    hf.reset_launch_counts()
    bank = stream.channelize(iq, channels)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in hf.KERNELS}
    log(f"phase 8 channelize(C=1024) on the capture: launches {launches}")
    require(tuple(bank.shape) == (channels, K4_PATH[1]), f"bank {tuple(bank.shape)}")
    # The same channelizer with K4's plain version (the Stockham engine's
    # complex transform is cfft_plain's ordered path) on the same input:
    # every bin of every row, relative to the output's peak, bound 2e-7*C.
    plain = stream.channelize(iq, channels, engine="stockham")
    rel = max_err(bank, plain) / float(plain.abs().max())
    log(f"phase 8 channelize(C=1024) K4 vs its plain version: max abs err / peak {rel:.3e} "
        f"(bound {TOL * channels:.3e})")
    require(rel <= TOL * channels, f"channelize(C=1024) K4 vs plain: {rel:.3e} > {TOL * channels:.3e}")
    proto64 = stream.design_lowpass(channels * 8, 1.0 / channels, device="cpu").double().numpy()
    # The carriers sit on channel 2*ch of a 1024-channel bank at the wideband rate.
    chans = tuple(sorted({2 * CARRIERS[0], 2 * CARRIERS[3], 1024 - 2 * (256 - CARRIERS[-1]), 0, 300, 700}))
    check_channels("phase 8 channelizer (C=1024)", bank, capture.astype(np.complex128), proto64, chans)
    log("phase 8 ok")
    return launches


def phase9(hf, stream, dev, x: torch.Tensor, h: torch.Tensor, ref: np.ndarray) -> dict[str, int]:
    """PartitionedFIR at block 128 (N = 256) on config 3's streams."""
    block = 128
    s = x.shape[0]
    hf.reset_launch_counts()
    y_off = stream.partitioned_fir_apply(x, h, block=block)
    fir = stream.PartitionedFIR(h, block=block)
    state = fir.init_state((s,))
    k_blocks, chunks = 64, 4
    outs = []
    for c in range(chunks):
        xb = x[:, c * k_blocks * block : (c + 1) * k_blocks * block].reshape(s, k_blocks, block)
        state, yk = fir.step_k(state, xb)
        outs.append(yk.reshape(s, -1))
    y_stream = torch.cat(outs, -1)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in hf.KERNELS}
    log(f"phase 9 PartitionedFIR(block=128): launches {launches}")
    err_f64 = float(np.abs(y_off.double().cpu().numpy() - ref).max())
    err_stream = float((y_stream - y_off[:, : y_stream.shape[-1]]).abs().max())
    log(f"phase 9 partitioned_fir_apply(block=128) vs float64 {err_f64:.3e} (atol 1e-3); "
        f"step_k x{chunks} (K={k_blocks}) vs offline {err_stream:.3e} (atol 1e-5)")
    require(err_f64 <= 1e-3, f"partitioned_fir_apply(block=128): {err_f64} > 1e-3")
    require(err_stream <= 1e-5, f"step_k disagrees with partitioned_fir_apply: {err_stream}")
    log("phase 9 ok")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: timing of K4/K5 and the config-5 chain
# ---------------------------------------------------------------------------


def kernel_device_times(fn) -> dict[str, float]:
    """Device time (ms) by kernel name for one call of ``fn``, from
    torch.profiler's device-side events only (not the aten ops that
    launched them, which repeat the same time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def phase11(ct, hopper_cfft, hopper_small, row_passes, models, stream, lib, dev, capture, x, h,
            card) -> dict[str, dict]:
    """K4 at the headline shape and the three K5 bodies at N=256, B=32768
    (kernel_times; the inverse library calls unscaled, norm="forward", as
    the kernels are), K5's launch geometry and resident blocks per SM;
    then the config-5 chain and the block-128 PartitionedFIR on config 3's
    streams (wall, device time by kernel, idle share)."""
    times: dict[str, dict] = {}
    n, rows = HEADLINE
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    args = [(torch.randn(rows, n, dtype=torch.complex64, device=dev),) for _ in range(4)]
    times[hopper_cfft.K4.name] = kernel_times(lambda z: hopper_cfft.cfft_kernel(z, plan, True, True),
                                              lambda z: hopper_cfft.cfft_plain(z, plan, True, True), args,
                                              lambda z: torch.fft.fft(z))
    log_times(11, hopper_cfft.K4.name, f"N={n} B={rows} complex64 forward", times[hopper_cfft.K4.name], card)
    g = row_passes.launch_geometry(plan, rows)
    log(f"phase 11 {hopper_cfft.K4.name} geometry: {g.passes}, {g.rows_per_block} rows and {g.threads} threads a "
        f"block, {g.smem_bytes} B; {lib.hopper_complex_fft_blocks_per_sm(g.threads, g.smem_bytes)} resident blocks "
        "per SM")
    del args

    n, rows = SMALL_TIMED
    cplan, rplan = ct.cached_plan(n, ct.FFT_COMPLEX), ct.cached_plan(n, ct.FFT_REAL)
    zs = [(torch.randn(rows, n, dtype=torch.complex64, device=dev),) for _ in range(2)]
    xs = [(torch.randn(rows, n, device=dev),) for _ in range(2)]
    specs = [hopper_small.small_rfft_kernel(v, rplan) for (v,) in xs]
    cspecs = [(torch.fft.rfft(v),) for (v,) in xs]
    times[hopper_small.K5_COMPLEX.name] = kernel_times(
        lambda z: hopper_small.small_cfft_kernel(z, cplan, False),
        lambda z: hopper_small.small_cfft_plain(z, cplan, False), zs, lambda z: torch.fft.ifft(z, norm="forward"))
    times[hopper_small.K5_REAL.name] = kernel_times(
        lambda v: hopper_small.small_rfft_kernel(v, rplan),
        lambda v: hopper_small.small_rfft_plain(v, rplan), xs, lambda v: torch.fft.rfft(v))
    times[hopper_small.K5_REAL_INVERSE.name] = kernel_times(
        lambda r, i: hopper_small.small_irfft_kernel(r, i, rplan),
        lambda r, i: hopper_small.small_irfft_plain(r, i, rplan), specs,
        lambda c: torch.fft.irfft(c, n=n, norm="forward"), cspecs)
    del zs, xs, specs, cspecs
    for body, (k, kind, form) in enumerate(((hopper_small.K5_COMPLEX, "complex", "complex64 backward"),
                                            (hopper_small.K5_REAL, "real", "forward"),
                                            (hopper_small.K5_REAL_INVERSE, "real", "inverse"))):
        g = hopper_small.launch_geometry(n, kind, rows)
        blocks = lib.hopper_small_fft_blocks_per_sm(body, g.threads, g.smem_bytes)
        require(blocks >= 1, f"{k.name}: {blocks} resident blocks per SM")
        times[k.name]["blocks_per_sm"] = blocks
        log_times(11, k.name, f"N={n} B={rows} {form}", times[k.name], card)
        log(f"phase 11 {k.name} geometry: tiles of {g.tile_rows} rows, {g.threads} threads, {g.smem_bytes} B of "
            f"shared memory, {g.grid} blocks; {blocks} resident blocks per SM")

    chain = models.SDRChain(models.SDRChainConfig(), device=dev)
    iq = torch.from_numpy(capture).to(dev)
    breakdown(11, "config 5 chain (2^24 samples)", lambda: chain(iq), wall_ms(lambda: chain(iq), 7), card, top=12)
    del chain, iq

    # The K5-real path: partitioned_fir_apply at block 128 (N = 256) on
    # config 3's streams, as phase 9 runs it.
    def fir():
        return stream.partitioned_fir_apply(x, h, block=128)

    by_kernel = breakdown(11, f"partitioned_fir_apply(block=128) on config 3 ({x.shape[0]} x {x.shape[1]}, "
                              f"{h.shape[0]} taps)", fir, wall_ms(fir, 7), card, top=12)
    k5 = {k.name: sum(ms for name, ms in by_kernel.items() if k.name in name)
          for k in (hopper_small.K5_REAL, hopper_small.K5_REAL_INVERSE)}
    log(f"phase 11 block-128 FIR: K5 device time " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in k5.items())
        + f" of {sum(by_kernel.values()):.3f} ms [{card}]")

    # Config 3's main path as phase 3 runs it: fir_filter_ols at block 8192
    # (K1, K3 at N = 16384) and partitioned_fir_apply at block 1024 (K1,
    # the packed convolve-accumulate, K2 at N = 2048).
    symbols = {"K1": "::rfft_packed_kernel(", "K2": "irfft_packed_kernel<false>", "K3": "irfft_packed_kernel<true>"}
    for name, fn in (("fir_filter_ols(block=8192) on config 3", lambda: stream.fir_filter_ols(x, h, block=8192)),
                     ("partitioned_fir_apply(block=1024) on config 3",
                      lambda: stream.partitioned_fir_apply(x, h, block=1024))):
        by_kernel = breakdown(11, name, fn, wall_ms(fn, 7), card, top=8)
        rows = {k: sum(ms for kname, ms in by_kernel.items() if sym in kname) for k, sym in symbols.items()}
        log(f"phase 11 {name}: K1-K3 device time " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in rows.items())
            + f" of {sum(by_kernel.values()):.3f} ms [{card}]")
    return times


# ---------------------------------------------------------------------------
# Phase 12: the composite kernels (K6, K7a, K7b) against their plain
# versions and float64
# ---------------------------------------------------------------------------

COMPOSITE_COMPLEX = ((16384, 7), (65536, 4), (1 << 17, 3), (196608, 2), (1 << 18, 5), (1 << 20, 2))
COMPOSITE_REAL = ((32768, 5), (1 << 17, 4), (1 << 18, 3), (3 << 18, 2), (1 << 20, 3))
CONFIG2_TOP = (1 << 20, 64)  # BASELINE config 2's largest N, at bench.py's batch of 64
LEVEL_N = 1 << 20  # phase 12 holds a column kernel at every length on the path of the largest composite
REVERB = {"channels": 64, "seconds": 10, "ir_seconds": 2, "rate": 48000}
REVERB_ATOL = 1e-3  # vs float64: config 3's atol; the wet signal's rms is ~0.8 here
REVERB_ENGINE_ATOL = 2e-4  # vs the same call on the Stockham engine (two float32 paths)


def held(got, want, n: int, length: int) -> tuple[float, float]:
    """(max abs error of ``got`` against ``want``, its bound) for a kernel
    of transform length ``length`` on the path of an N-point transform:
    2e-7*N, or 2e-7*length times ``want``'s rms where that is smaller.
    An output far below unit scale (an intermediate divided by N) is thus
    held below its own size, and a kernel to its own length's bound: a
    zeroed output or a dropped bin fails."""
    if isinstance(want, torch.Tensor):  # both on the card: compute there
        wide = torch.complex128 if (want.is_complex() or got.is_complex()) else torch.float64
        w = want.to(wide)
        if not w.numel():
            return 0.0, TOL * n
        err = float((got.to(wide) - w).abs().max())
        return err, TOL * min(n, length * float(w.abs().pow(2).mean().sqrt()))
    w = np.asarray(want)
    rms = float(np.sqrt(np.mean(np.abs(w.astype(np.complex128)) ** 2))) if w.size else 1.0
    return max_err(got, w), TOL * min(n, length * rms)


def phase12(ct, hc, dev, rng) -> dict[str, float]:
    """Each composite kernel against its plain version on the same input,
    and each composite against float64 (outputs of backward transforms
    divided by N; K7b's, of its length-A inverse, divided by A), bound
    ``held``'s at the kernel's length (A for level 1, K7a and K7b, C for
    level 2) or at N for a whole composite. Returns each kernel's worst
    error against its plain version."""
    worst = {k.name: 0.0 for k in hc.KERNELS}
    caught: dict[str, float] = {}

    def note(kernel, key, got, want, n, length):
        err, bound = held(got, want, n, length)
        if kernel is not None:
            worst[kernel.name] = max(worst[kernel.name], err)
        require(err <= bound, f"{key}: max abs err {err:.3e} > {bound:.3e}")

    def cx(v):
        return v if isinstance(v, torch.Tensor) else torch.complex(*v)

    def planes(v):
        return torch.cat([v[0], v[1]], -1)

    for n, rows in COMPOSITE_COMPLEX:
        a, c = hc.split_large(n)
        pa, pc = ct.cached_plan(a, ct.FFT_COMPLEX), ct.cached_plan(c, ct.FFT_COMPLEX)
        z = crandn(rng, (rows, n))
        z64 = z.astype(np.complex128)
        zt = torch.from_numpy(z).to(dev)
        for form in ("complex64", "planes"):
            x = zt if form == "complex64" else (zt.real.contiguous(), zt.imag.contiguous())
            tag = f"N={n} ({a}x{c}) rows={rows} {form}"
            x3 = hc._view(x, (rows, a, c))
            mid = hc.level1(x3, pa, True)
            note(hc.K6_L1, f"{tag} l1", cx(mid), cx(hc.level1_plain(x3, pa, True)), n, a)
            tw = hc.twiddle(n, True, dev)
            y = hc.level2(mid, tw, pc, True)
            note(hc.K6_L2, f"{tag} l2", cx(y), cx(hc.level2_plain(mid, tw, pc, True)), n, c)
            note(None, f"{tag} forward vs float64", cx(y).reshape(rows, n), np.fft.fft(z64), n, n)
            twb = hc.twiddle(n, False, dev)
            s3 = hc._view(y, (rows, c, a))
            back_mid = hc.level2(s3, twb, pc, False)
            note(hc.K6_L2_REV, f"{tag} l2_rev", cx(back_mid) / n,
                 cx(hc.level2_plain(s3, twb, pc, False)) / n, n, c)
            back = hc.level1(back_mid, pa, False)
            note(hc.K6_L1_REV, f"{tag} l1_rev", cx(back) / n,
                 cx(hc.level1_plain(back_mid, pa, False)) / n, n, a)
            note(None, f"{tag} backward vs float64", cx(back).reshape(rows, n) / n, z64, n, n)

    for n, rows in COMPOSITE_REAL:
        a, c = hc.split_large(n, real=True)
        plan = ct.cached_plan(n, ct.FFT_REAL)
        pa, pc = ct.cached_plan(a, ct.FFT_REAL), ct.cached_plan(c, ct.FFT_COMPLEX)
        x64 = rng.standard_normal((rows, n))
        ref_re, ref_im = packed_ref(x64)
        xt = torch.from_numpy(x64.astype(np.float32)).to(dev)
        tag = f"real N={n} ({a}x{c}) rows={rows}"
        x3 = xt.reshape(rows, a, c)
        pre, pim = hc.rfft_cols(x3, pa)
        note(hc.K7A, f"{tag} k7a", planes((pre, pim)), planes(hc.rfft_cols_plain(x3, pa)), n, a)
        tw = hc.real_twiddle(n, True, dev)
        g = hc.level2((pre, pim), tw, pc, True)
        note(hc.K6_L2, f"{tag} l2", planes(g), planes(hc.level2_plain((pre, pim), tw, pc, True)), n, c)
        re, im = hc.rfft_composite(xt, plan)
        note(None, f"{tag} forward vs float64", planes((re, im)), np.concatenate([ref_re, ref_im], -1), n, n)
        sre = torch.from_numpy(ref_re.astype(np.float32)).to(dev)
        sim = torch.from_numpy(ref_im.astype(np.float32)).to(dev)
        back = hc.irfft_composite(sre, sim, plan)
        note(None, f"{tag} backward vs float64", back / n, x64.astype(np.float32), n, n)
        grid = (torch.randn(rows, c, a // 2, device=dev), torch.randn(rows, c, a // 2, device=dev))
        twb = hc.real_twiddle(n, False, dev)
        u = hc.level2(grid, twb, pc, False)
        note(hc.K6_L2_REV, f"{tag} l2_rev", planes(u), planes(hc.level2_plain(grid, twb, pc, False)), n, c)
        # K7b on the packed spectrum of the unit-scale columns x3: its
        # length-A inverse divided by A is x3 again.
        xb = hc.irfft_cols(pre, pim, pa)
        want = hc.irfft_cols_plain(pre, pim, pa) / a
        note(hc.K7B, f"{tag} k7b", xb / a, want, n, a)
        note(None, f"{tag} k7b(k7a(x)) vs x", xb / a, x64.astype(np.float32).reshape(rows, a, c), n, a)
        # The check can fail: a zeroed K7b output, and K7b with the Nyquist
        # slot (im[..., 0]) dropped from its input.
        no_nyq = pim.clone()
        no_nyq[..., 0] = 0
        for bad, out in (("k7b zeroed", torch.zeros_like(xb)), ("k7b no Nyquist", hc.irfft_cols(pre, no_nyq, pa))):
            err, bound = held(out / a, want, n, a)
            require(err > bound, f"{tag} k7b check passes a {bad} output: {err:.3e} <= {bound:.3e}")
            caught[bad] = min(caught.get(bad, np.inf), err / bound)
    # Every column length the composite's splits produce: K6's four roles
    # on 3 batch rows of a ragged M = 37 columns, complex64 and planes, K7a
    # on unit-scale columns and K7b on their packed spectrum, each held on the
    # path of the largest composite (2^20), i.e. at its own length's bound.
    lengths, real_lengths = hc.column_lengths()
    cols = 37
    for length in lengths:
        plan = ct.cached_plan(length, ct.FFT_COMPLEX)
        z = torch.from_numpy(crandn(rng, (3, length, cols))).to(dev)
        zr = torch.from_numpy(crandn(rng, (3, cols, length))).to(dev)
        tw = torch.polar(torch.ones(length, cols, device=dev), torch.rand(length, cols, device=dev) * 6.2832)
        for form in ("complex64", "planes"):
            def f(v, form=form):
                return v if form == "complex64" else (v.real.contiguous(), v.imag.contiguous())
            tag = f"L={length} {form}"
            note(hc.K6_L1, f"{tag} l1", cx(hc.level1(f(z), plan, True)), hc.level1_plain(z, plan, True),
                 LEVEL_N, length)
            note(hc.K6_L2, f"{tag} l2", cx(hc.level2(f(z), tw, plan, True)), hc.level2_plain(z, tw, plan, True),
                 LEVEL_N, length)
            note(hc.K6_L2_REV, f"{tag} l2_rev", cx(hc.level2(f(z), tw, plan, False)),
                 hc.level2_plain(z, tw, plan, False), LEVEL_N, length)
            note(hc.K6_L1_REV, f"{tag} l1_rev", cx(hc.level1(f(zr), plan, False)), hc.level1_plain(zr, plan, False),
                 LEVEL_N, length)
    for a in real_lengths:
        plan = ct.cached_plan(a, ct.FFT_REAL)
        x = torch.from_numpy(rng.standard_normal((3, a, cols)).astype(np.float32)).to(dev)
        # K7a on unit-scale columns, against its plain version and float64;
        # the check fails a zeroed output and one whose Nyquist slot
        # (im[..., 0]) is zeroed.
        got = planes(hc.rfft_cols(x, plan))
        want = planes(hc.rfft_cols_plain(x, plan))
        note(hc.K7A, f"A={a} k7a", got, want, LEVEL_N, a)
        spec = np.fft.rfft(x.double().cpu().numpy(), axis=1).transpose(0, 2, 1)
        ref_im = spec.imag[..., : a // 2].copy()
        ref_im[..., 0] = spec[..., a // 2].real
        note(None, f"A={a} k7a vs float64", got, np.concatenate([spec.real[..., : a // 2], ref_im], -1), LEVEL_N, a)
        no_nyq = got.clone()
        no_nyq[..., a // 2] = 0
        for bad, out in (("k7a zeroed", torch.zeros_like(got)), ("k7a no Nyquist", no_nyq)):
            err, bound = held(out, want, LEVEL_N, a)
            require(err > bound, f"A={a} k7a check passes a {bad} output: {err:.3e} <= {bound:.3e}")
            caught[bad] = min(caught.get(bad, np.inf), err / bound)
        pre, pim = hc.rfft_cols_plain(x, plan)
        xb = hc.irfft_cols(pre, pim, plan)
        note(hc.K7B, f"A={a} k7b", xb / a, hc.irfft_cols_plain(pre, pim, plan) / a, LEVEL_N, a)
        note(None, f"A={a} k7b vs x", xb / a, x, LEVEL_N, a)
    log(f"phase 12: K6 (four roles, complex64 and planes) at all {len(lengths)} column lengths "
        f"{lengths[0]}..{lengths[-1]} and K7a, K7b at all {len(real_lengths)} lengths A {real_lengths[0]}..{real_lengths[-1]}, "
        f"3 rows of {cols} columns, within their bounds of their plain versions")
    torch.cuda.synchronize()
    log("phase 12 ok: K6 (four roles), K7a, K7b within their bounds of their plain versions, composites "
        "of float64; " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + "; the K7a and K7b checks fail "
        + ", ".join(f"a {bad} output by at least {r:.0f}x its bound" for bad, r in caught.items()))
    return worst


# ---------------------------------------------------------------------------
# Phase 13: BASELINE config 2's top row; phase 14: the long-IR reverb
# ---------------------------------------------------------------------------


def phase13(ct, hc, hf, dev, rng) -> dict[str, int]:
    """ct.fft / ifft / rfft_packed / irfft_packed with engine="auto" at
    N = 2^20, B = 64: every row against the plain composite on the card,
    4 rows against float64; each new kernel carried it."""
    n, rows = CONFIG2_TOP
    bound = TOL * n
    for kind in ("complex", "real"):
        require(ct.engine_for(n, kind) == "hopper", f"engine_for({n}, {kind}) = {ct.engine_for(n, kind)}")
    z = torch.randn(rows, n, dtype=torch.complex64, device=dev)
    x = torch.randn(rows, n, device=dev)
    cplan, rplan = ct.cached_plan(n, ct.FFT_COMPLEX), ct.cached_plan(n, ct.FFT_REAL)
    hf.reset_launch_counts()
    y = ct.fft(z)
    zb = ct.ifft(y)
    re, im = ct.rfft_packed(x)
    xb = ct.irfft_packed(re, im)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in hf.KERNELS}
    log(f"phase 13 config 2 top row (N=2^20, B=64; fft, ifft, rfft_packed, irfft_packed): launches {launches}")
    for k in hc.KERNELS:
        require(launches[k.name] > 0, f"{k.name} was not launched on config 2's top row")
    errs = {
        "fft vs plain": max_err(y, hc.cfft_composite(z, cplan, True, plain=True)),
        "ifft vs plain": max_err(zb / n, hc.cfft_composite(y, cplan, False, plain=True) / n),
        "rfft_packed vs plain": max(max_err(a, b) for a, b in zip((re, im), hc.rfft_composite(x, rplan, plain=True))),
        "irfft_packed vs plain": max_err(xb / n, hc.irfft_composite(re, im, rplan, plain=True) / n),
    }
    z64 = z[:4].cpu().numpy().astype(np.complex128)
    x64 = x[:4].double().cpu().numpy()
    ref_re, ref_im = packed_ref(x64)
    errs["fft vs float64 (4 rows)"] = max_err(y[:4], np.fft.fft(z64))
    errs["ifft vs float64 (4 rows)"] = max_err(zb[:4] / n, z64)
    errs["rfft_packed vs float64 (4 rows)"] = max(max_err(re[:4], ref_re), max_err(im[:4], ref_im))
    errs["irfft_packed vs float64 (4 rows)"] = max_err(xb[:4] / n, x64)
    for key, err in errs.items():
        require(err <= bound, f"config 2 top row {key}: {err:.3e} > {bound:.3e}")
    log("phase 13 ok: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (bound {bound:.3e})")
    return launches


def make_reverb(rng) -> tuple[np.ndarray, np.ndarray]:
    """64 channels x 10 s of noise at 48 kHz and per-channel 2 s impulse
    responses of exponentially decaying noise (examples/02_convolution_reverb.py)."""
    c, sr = REVERB["channels"], REVERB["rate"]
    taps = REVERB["ir_seconds"] * sr
    ir = rng.standard_normal((c, taps)) * np.exp(-np.linspace(0, 8, taps)) / 100
    audio = rng.standard_normal((c, REVERB["seconds"] * sr))
    return audio.astype(np.float32), ir.astype(np.float32)


def phase14(ct, hc, hf, stream, dev, audio: np.ndarray, ir: np.ndarray) -> dict[str, int]:
    """stream.fir_filter_ols(audio, ir) with engine="auto": N = 2^19 and
    2 blocks per channel, 128 rows through K7a, K6 level 2, the line
    transforms (K4 at C = 512), K6 level-2 reverse and K7b."""
    x = torch.from_numpy(audio).to(dev)
    h = torch.from_numpy(ir).to(dev)
    taps = ir.shape[-1]
    n = stream.next_fft_size(max(256, stream.next_fft_size(4 * taps) // 2) + taps - 1)
    a, c = hc.split_large(n, real=True)
    require(n == 1 << 19 and ct.engine_for(n, "real") == "hopper", f"reverb N={n}, {ct.engine_for(n, 'real')}")
    hf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wet = stream.fir_filter_ols(x, h)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS}
    log(f"phase 14 reverb (64 ch x 10 s, 2 s IRs, N={n} = {a}x{c}) ran in {wall:.3f} s (first call, host clock); "
        f"launches {launches}")
    for k in (hc.K7A, hc.K6_L2, hc.K6_L2_REV, hc.K7B, hf.K4):
        require(launches[k.name] > 0, f"{k.name} was not launched on the reverb path")
    require(tuple(wet.shape) == audio.shape and bool(torch.isfinite(wet).all()), f"wet {tuple(wet.shape)}")
    got = wet[:8].double().cpu().numpy()
    ref = fft_convolve64(audio[:8].astype(np.float64), ir[:8].astype(np.float64))
    err64 = float(np.abs(got - ref).max())
    rms = float(np.sqrt((ref ** 2).mean()))
    plain = stream.fir_filter_ols(x, h, engine="stockham")
    err_eng = float((wet - plain).abs().max())
    log(f"phase 14 reverb: 8 channels vs float64 max abs err {err64:.3e} (atol {REVERB_ATOL}, wet rms {rms:.3f}); "
        f"64 channels vs engine=stockham {err_eng:.3e} (atol {REVERB_ENGINE_ATOL})")
    require(err64 <= REVERB_ATOL, f"reverb vs float64: {err64} > {REVERB_ATOL}")
    require(err_eng <= REVERB_ENGINE_ATOL, f"reverb vs stockham: {err_eng} > {REVERB_ENGINE_ATOL}")
    log("phase 14 ok")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: timing of the composite kernels and the reverb path
# ---------------------------------------------------------------------------


def phase15(ct, hc, roof, stream, lib, dev, card, audio: np.ndarray, ir: np.ndarray) -> dict[str, dict]:
    """Returns each composite kernel's kernel_times at config 2's top row,
    with its bound under "bound"; logs the column engine's launch geometry
    and resident blocks per SM there, K6 level 2 on the real composite's
    planes and K7a at the reverb's shape."""
    from chowdsp_fft_tpu_torch.ops import col_passes

    n, rows = CONFIG2_TOP
    a, c = hc.split_large(n)
    pa, pc = ct.cached_plan(a, ct.FFT_COMPLEX), ct.cached_plan(c, ct.FFT_COMPLEX)
    zs = [(torch.randn(rows, n, dtype=torch.complex64, device=dev),) for _ in range(2)]
    x3 = [(z.reshape(rows, a, c),) for (z,) in zs]
    mids = [(hc.level1(v, pa, True),) for (v,) in x3]
    tw, twb = hc.twiddle(n, True, dev), hc.twiddle(n, False, dev)
    out: dict[str, dict] = {}
    out[hc.K6_L1.name] = kernel_times(lambda v: hc.level1(v, pa, True), lambda v: hc.level1_plain(v, pa, True), x3,
                                      lambda v: torch.fft.fft(v, dim=1))
    out[hc.K6_L1.name]["bound"] = roof.level_roofline(n, rows, a)
    out[hc.K6_L2.name] = kernel_times(lambda v: hc.level2(v, tw, pc, True),
                                      lambda v: hc.level2_plain(v, tw, pc, True), mids)
    out[hc.K6_L2.name]["bound"] = roof.level_roofline(n, rows, c, table_points=n)
    out[hc.K6_L2_REV.name] = kernel_times(lambda v: hc.level2(v, twb, pc, False),
                                          lambda v: hc.level2_plain(v, twb, pc, False), mids)
    out[hc.K6_L2_REV.name]["bound"] = roof.level_roofline(n, rows, c, table_points=n)
    out[hc.K6_L1_REV.name] = kernel_times(lambda v: hc.level1(v, pa, False),
                                          lambda v: hc.level1_plain(v, pa, False), mids,
                                          lambda v: torch.fft.ifft(v, dim=-1, norm="forward"))
    out[hc.K6_L1_REV.name]["bound"] = roof.level_roofline(n, rows, a)
    cplan = ct.cached_plan(n, ct.FFT_COMPLEX)
    whole = {
        "fft": (time_ms(lambda v: ct.fft(v), zs), time_ms(lambda v: torch.fft.fft(v), zs),
                time_ms(lambda v: hc.cfft_composite(v, cplan, True, plain=True), zs)),
        "ifft": (time_ms(lambda v: ct.ifft(v), zs), time_ms(lambda v: torch.fft.ifft(v), zs),
                 time_ms(lambda v: hc.cfft_composite(v, cplan, False, plain=True), zs)),
    }
    del zs, x3, mids

    ra, rc = hc.split_large(n, real=True)
    pra = ct.cached_plan(ra, ct.FFT_REAL)
    rplan = ct.cached_plan(n, ct.FFT_REAL)
    for k, role, plan, cols, form, seg in (
            (hc.K6_L1, 0, pa, c, "complex64", 8), (hc.K6_L2, 1, pc, a, "complex64", 8),
            (hc.K6_L2_REV, 2, pc, a, "complex64", 8), (hc.K6_L1_REV, 3, pa, c, "complex64", 8),
            (hc.K6_L2, 1, ct.cached_plan(rc, ct.FFT_COMPLEX), ra // 2, "planes", 4),
            (hc.K6_L2_REV, 2, ct.cached_plan(rc, ct.FFT_COMPLEX), ra // 2, "planes", 4),
            (hc.K7B, 4, pra, rc, "real", 4), (hc.K7A, 5, pra, rc, "real", 4)):
        g = col_passes.launch_geometry(plan, rows, cols, seg, hc.in_place_role(k, seg // 4))
        log(f"phase 15 {k.name} geometry ({form}, L={plan.n if role < 4 else plan.n // 2}): passes {g.passes}, "
            f"{g.lanes} columns and {g.threads} threads a block, {g.buffers} tile buffer(s) of {g.smem_bytes} B; "
            f"{lib.hopper_composite_blocks_per_sm(role, g.shape, g.threads, g.smem_bytes)} resident blocks per SM")

    # K6 level 2 on the real composite's (B, C, A/2) planes.
    prc = ct.cached_plan(rc, ct.FFT_COMPLEX)
    grids = [((torch.randn(rows, rc, ra // 2, device=dev), torch.randn(rows, rc, ra // 2, device=dev)),)
             for _ in range(2)]
    rtw, rtwb = hc.real_twiddle(n, True, dev), hc.real_twiddle(n, False, dev)
    planes_bound = roof.level_roofline(n // 2, rows, rc, table_points=n // 2)
    for k, twt, fwd in ((hc.K6_L2, rtw, True), (hc.K6_L2_REV, rtwb, False)):
        t = kernel_times(lambda v: hc.level2(v, twt, prc, fwd), lambda v: hc.level2_plain(v, twt, prc, fwd), grids)
        log_times(15, k.name, f"planes of the real composite (B=64, C={rc}, A/2={ra // 2}; bound "
                              f"{planes_bound.ms:.4f} ms, {planes_bound.bound_by})", t, card)
    del grids
    xs = [(torch.randn(rows, n, device=dev),) for _ in range(2)]
    xr3 = [(x.reshape(rows, ra, rc),) for (x,) in xs]
    packed = [hc.rfft_cols(v, pra) for (v,) in xr3]
    out[hc.K7A.name] = kernel_times(lambda v: hc.rfft_cols(v, pra), lambda v: hc.rfft_cols_plain(v, pra), xr3,
                                    lambda v: torch.fft.rfft(v, dim=1))
    out[hc.K7A.name]["bound"] = roof.level_roofline(n, rows, ra, "real")
    # K7a at the reverb's shape (N = 2^19, two blocks a channel: the same
    # bytes as config 2's top row).
    vn, vrows = 1 << 19, 2 * REVERB["channels"]
    va, vc = hc.split_large(vn, real=True)
    pva = ct.cached_plan(va, ct.FFT_REAL)
    xv = [(torch.randn(vrows, va, vc, device=dev),) for _ in range(2)]
    t = kernel_times(lambda v: hc.rfft_cols(v, pva), lambda v: hc.rfft_cols_plain(v, pva), xv,
                     lambda v: torch.fft.rfft(v, dim=1))
    vb = roof.level_roofline(vn, vrows, va, "real")
    log_times(15, hc.K7A.name, f"at the reverb's shape (N=2^19, B={vrows}, A={va}, C={vc}; bound {vb.ms:.4f} ms, "
                               f"{vb.bound_by})", t, card)
    del xv
    specs = [(torch.fft.rfft(v.transpose(1, 2), dim=-1),) for (v,) in xr3]
    out[hc.K7B.name] = kernel_times(lambda r, i: hc.irfft_cols(r, i, pra),
                                    lambda r, i: hc.irfft_cols_plain(r, i, pra), packed,
                                    lambda sp: torch.fft.irfft(sp, n=ra, dim=-1, norm="forward"), specs)
    out[hc.K7B.name]["bound"] = roof.level_roofline(n, rows, ra, "real")
    del specs
    rspecs = [ct.rfft_packed(x) for (x,) in xs]
    cuspecs = [(torch.fft.rfft(x),) for (x,) in xs]
    whole["rfft_packed"] = (time_ms(lambda v: ct.rfft_packed(v), xs), time_ms(lambda v: torch.fft.rfft(v), xs),
                            time_ms(lambda v: hc.rfft_composite(v, rplan, plain=True), xs))
    whole["irfft_packed"] = (time_ms(lambda r, i: ct.irfft_packed(r, i), rspecs),
                             time_ms(lambda s: torch.fft.irfft(s, n=n), cuspecs),
                             time_ms(lambda r, i: hc.irfft_composite(r, i, rplan, plain=True), rspecs))
    del xs, xr3, packed, rspecs, cuspecs

    for k in hc.KERNELS:
        log_times(15, k.name, f"(N=2^20, B=64; bound {out[k.name]['bound'].ms:.4f} ms, "
                              f"{out[k.name]['bound'].bound_by})", out[k.name], card)
    for name, (ms, lib, plain_ms) in whole.items():
        kind = "complex" if name in ("fft", "ifft") else "real"
        bound = roof.fft_roofline(n, rows, kind)
        log(f"phase 15 ct.{name} (N=2^20, B=64, auto): {ms:.4f} ms, torch.fft {lib:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound.ms:.4f} ms ({bound.bound_by}; {bound.bytes / 1e6:.1f} MB) [{card}]")

    x = torch.from_numpy(audio).to(dev)
    h = torch.from_numpy(ir).to(dev)
    wall = wall_ms(lambda: stream.fir_filter_ols(x, h), 5)
    by_kernel = kernel_device_times(lambda: stream.fir_filter_ols(x, h))
    device_ms = sum(by_kernel.values())
    blocks = audio.shape[0] * 2
    bound = roof.conv_roofline(1 << 19, blocks)
    log(f"phase 15 reverb fir_filter_ols (64 ch x 10 s, 2 s IRs): wall {wall:.3f} ms per call (median of 5, "
        f"host clock), device {device_ms:.3f} ms, idle share {1 - device_ms / wall:.2f}; one OLS round's "
        f"bound {bound.ms:.4f} ms ({bound.bound_by}) [{card}]")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {ms:9.4f} ms  {name[:110]}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: BASELINE config 4; phase 17: the STFT; phase 18: the pipelined
# kernels against their grid kernels; phase 19: their timing
# ---------------------------------------------------------------------------

CONFIG4_BLOCK = 4096  # examples/02_convolution_reverb.py: ConvolverConfig(channels=64, block=4096)
CONFIG4_STEPS = 8
CONFIG4_ATOL = 1e-3  # vs float64 (test_models.py:35)
CONFIG4_STREAM_ATOL = 1e-4  # streaming vs offline (test_models.py:49)
STFT = (1024, 512)  # (n_fft, hop)
STFT_ATOL = 1e-4  # round trip (test_stream.py:248)
STFT_CHANNELS = 4  # channels held against float64 frames
REAL_DB_SHAPES = (HEADLINE, (16384, 1024), (4096, 1000), (16384, 300), (4096, 1))
COMPLEX_DB_SHAPES = (HEADLINE, K4_PATH, (9216, 128), (13824, 256), (4096, 1000), (4096, 1))


@contextlib.contextmanager
def recording(module, name: str):
    """Record (arguments, result) of every call of ``module.name`` (a
    kernel wrapper that the engine looks up when it calls it)."""
    fn = getattr(module, name)
    calls = []

    def spy(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def phase16(models, hf, convolve, dev, audio: np.ndarray, ir: np.ndarray) -> tuple[dict[str, int], dict]:
    """config 4 as examples/02_convolution_reverb.py deploys it: the model
    built from the numpy IR bank on its default device, the offline FDL on
    64 channels x 10 s (N = 8192, P = 24, 118 blocks; one launch of the
    partitioned accumulate), then init_state and 8 step calls. Returns the
    path's launches and the model's own K1 call (frames in, spectra out)
    and K2 call (accumulated spectra in, blocks out), recorded on the way."""
    channels, t = audio.shape
    cfg = models.ConvolverConfig(channels=channels, block=CONFIG4_BLOCK)
    x = torch.from_numpy(audio).to(dev)
    hf.reset_launch_counts()
    convolve.PARTITIONED.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = models.MultichannelConvolver(ir, cfg)
    with recording(hf, "rfft_packed_kernel") as k1_calls, recording(hf, "irfft_packed_kernel") as k2_calls:
        wet = conv.apply(x)
    fdl_launches = convolve.PARTITIONED.launches
    state = conv.init_state()
    blocks = []
    for i in range(CONFIG4_STEPS):
        state, y = conv.step(state, x[:, i * cfg.block : (i + 1) * cfg.block])
        blocks.append(y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS}
    launches[convolve.PARTITIONED.name] = fdl_launches
    nb = -(-t // cfg.block)
    log(f"phase 16 config 4 (MultichannelConvolver, {channels} ch x {t} samples, {ir.shape[-1]}-tap IRs, block "
        f"{cfg.block}: N={2 * cfg.block}, P={conv.fir.partitions}, {nb} blocks) built, applied and stepped "
        f"{CONFIG4_STEPS}x in {wall:.3f} s (first call, host clock); launches {launches}")
    require(conv.h_re.device.type == "cuda", f"the model built from a numpy IR lives on {conv.h_re.device}")
    for k in (hf.K1, hf.K2):
        require(launches[k.name] > 0, f"{k.name} was not launched on config 4's path")
    require(len(k1_calls) == 1 and len(k2_calls) == 1, f"apply made {len(k1_calls)} K1 and {len(k2_calls)} K2 calls")
    require(fdl_launches == 1, f"apply launched {convolve.PARTITIONED.name} {fdl_launches} times, not once")
    frames = k1_calls[0][0][0]
    require(tuple(frames.shape) == (channels * nb, 2 * cfg.block), f"config 4 frames {tuple(frames.shape)}")
    require(tuple(wet.shape) == audio.shape and bool(torch.isfinite(wet).all()), f"wet {tuple(wet.shape)}")
    ref = fft_convolve64(audio[:8].astype(np.float64), ir[:8].astype(np.float64))
    err64 = float(np.abs(wet[:8].double().cpu().numpy() - ref).max())
    plain = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=channels, block=cfg.block,
                                                                    engine="stockham")).apply(x)
    err_eng = float((wet - plain).abs().max())
    del plain
    streamed = torch.cat(blocks, -1)
    err_stream = float((streamed - wet[:, : streamed.shape[-1]]).abs().max())
    log(f"phase 16 config 4: 8 channels vs float64 {err64:.3e} (atol {CONFIG4_ATOL}, wet rms "
        f"{float(np.sqrt((ref ** 2).mean())):.3f}); {channels} channels vs engine=stockham {err_eng:.3e} (atol "
        f"{REVERB_ENGINE_ATOL}); {CONFIG4_STEPS} step blocks vs offline {err_stream:.3e} (atol {CONFIG4_STREAM_ATOL})")
    require(err64 <= CONFIG4_ATOL, f"config 4 vs float64: {err64} > {CONFIG4_ATOL}")
    require(err_eng <= REVERB_ENGINE_ATOL, f"config 4 vs stockham: {err_eng} > {REVERB_ENGINE_ATOL}")
    require(err_stream <= CONFIG4_STREAM_ATOL, f"config 4 streaming vs offline: {err_stream} > {CONFIG4_STREAM_ATOL}")
    log("phase 16 ok")
    return launches, {"k1": k1_calls[0], "k2": k2_calls[0]}


def phase17(stream, hf, dev, audio: np.ndarray) -> dict[str, int]:
    """spectrogram, then stft -> istft, on config 4's 64-channel audio at
    n_fft 1024, hop 512 (~60,000 rows of 1024 through K1 and K2)."""
    n_fft, hop = STFT
    channels, t = audio.shape
    x = torch.from_numpy(audio).to(dev)
    hf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    power = stream.spectrogram(x, n_fft=n_fft, hop=hop)
    spec = stream.stft(x, n_fft=n_fft, hop=hop)
    back = stream.istft(spec, hop=hop, length=t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS}
    nf = spec.shape[-2]
    log(f"phase 17 STFT (n_fft {n_fft}, hop {hop}, {channels} x {nf} frames): spectrogram, stft, istft in "
        f"{wall:.3f} s (first call, host clock); launches {launches}")
    for k in (hf.K1, hf.K2):
        require(launches[k.name] > 0, f"{k.name} was not launched on the STFT path")
    require(tuple(spec.shape) == (channels, nf, n_fft // 2 + 1) and spec.dtype == torch.complex64,
            f"stft {tuple(spec.shape)} {spec.dtype}")
    require(tuple(power.shape) == tuple(spec.shape) and bool(torch.isfinite(power).all())
            and bool((power >= 0).all()), "spectrogram")
    require(torch.equal(power, spec.real ** 2 + spec.imag ** 2), "spectrogram != |stft|^2")
    err_rt = float((back - x).abs().max())
    w = stream.hann_window(n_fft).astype(np.float64)
    s_host = spec[:STFT_CHANNELS].cpu().numpy()
    err64 = 0.0
    for c in range(STFT_CHANNELS):
        xp = np.pad(audio[c].astype(np.float64), (n_fft - hop, n_fft))
        frames = np.lib.stride_tricks.sliding_window_view(xp, n_fft)[::hop][:nf] * w
        err64 = max(err64, float(np.abs(s_host[c] - np.fft.rfft(frames, axis=-1)).max()))
    bound = TOL * n_fft * 4
    log(f"phase 17 STFT: round trip max abs err {err_rt:.3e} (atol {STFT_ATOL}); {STFT_CHANNELS} channels' "
        f"frames vs float64 {err64:.3e} (bound {bound:.3e})")
    require(err_rt <= STFT_ATOL, f"istft(stft(x)) vs x: {err_rt} > {STFT_ATOL}")
    require(err64 <= bound, f"stft vs float64 frames: {err64} > {bound}")
    log("phase 17 ok")
    return launches


def phase18(ct, hf, hc4, lib, dev, rng, model_calls: dict) -> tuple[dict[str, float], dict[str, int]]:
    """K1-db, K2-db and K4-db: torch.equal to their grid kernels and within
    ``held``'s bound (2e-7*N at unit scale) of their plain versions, at the
    headline shape, one block per SM (N=16384), the register-prefetch
    range (MAX_CN), ragged batches and a single row, and on config 4's own
    frames and accumulated spectra (recorded on the model's path), whose
    grid outputs the model produced. A zeroed db output must fail. Then
    the pipelined forms' own run, counted: config 4's frames and spectra
    through K1-db and K2-db, the C=1024 channelizer's transform through
    K4-db. Returns each db kernel's worst error against its plain
    version and the launches of that run."""
    db = (hf.K1_DB, hf.K2_DB, hc4.K4_DB)
    worst = {k.name: 0.0 for k in db}
    caught: dict[str, float] = {}

    def note(kernel, key, got, want, n):
        err, bound = held(got, want, n, n)
        worst[kernel.name] = max(worst[kernel.name], err)
        require(err <= bound, f"{key}: max abs err {err:.3e} > {bound:.3e}")
        if kernel.name not in caught:  # the check can fail: a zeroed output
            zero_err, _ = held(torch.zeros_like(got), want, n, n)
            require(zero_err > bound, f"{key}: a zeroed output passes ({zero_err:.3e} <= {bound:.3e})")
            caught[kernel.name] = zero_err / bound

    def real_case(x, n, ordered, tag):
        plan = ct.cached_plan(n, ct.FFT_REAL)
        m = n // 2
        joint = hf.rfft_packed_joint_kernel(x, plan, ordered)
        joint_db = hf.rfft_packed_joint_db_kernel(x, plan, ordered)
        require(torch.equal(joint_db, joint), f"{tag}: K1-db differs from K1")
        re, im = hf.rfft_packed_kernel(x, plan, ordered)
        require(torch.equal(joint[:, :m], re) and torch.equal(joint[:, m:], im), f"{tag}: joint K1 != planes")
        note(hf.K1_DB, f"{tag} K1-db", joint_db, hf.rfft_packed_joint_plain(x, plan, ordered), n)
        del joint, joint_db
        back_db = hf.irfft_packed_db_kernel(re, im, plan, ordered)
        require(torch.equal(back_db, hf.irfft_packed_kernel(re, im, plan, ordered)), f"{tag}: K2-db differs from K2")
        note(hf.K2_DB, f"{tag} K2-db", back_db / n, hf.irfft_packed_plain(re, im, plan, ordered) / n, n)

    for n, rows in REAL_DB_SHAPES:
        x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
        for ordered in (True, False):
            real_case(x, n, ordered, f"real N={n} rows={rows} {'ord' if ordered else 'unord'}")
    # K2-db against K2 at every size of phase 2's sweep, at its rows.
    sweep = [n for n in range(257, hf.MAX_N + 1) if hf._in_domain(n)]
    for n in sweep:
        plan = ct.cached_plan(n, ct.FFT_REAL)
        for rows in (1, *DOMAIN_ROWS[1:]):
            x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
            for ordered in (True, False):
                re, im = hf.rfft_packed_kernel(x, plan, ordered)
                require(torch.equal(hf.irfft_packed_db_kernel(re, im, plan, ordered),
                                    hf.irfft_packed_kernel(re, im, plan, ordered)),
                        f"K2-db differs from K2 at N={n} rows={rows} ordered={ordered}")
    (frames, plan8k, ordered), (yre, yim) = model_calls["k1"]
    n8k, m8k = plan8k.n, plan8k.n // 2
    for order in (True, False):
        real_case(frames, n8k, order, f"config 4 frames ({frames.shape[0]} x {n8k}) {'ord' if order else 'unord'}")
    joint_db = hf.rfft_packed_joint_db_kernel(frames, plan8k, ordered)
    require(torch.equal(joint_db[:, :m8k], yre) and torch.equal(joint_db[:, m8k:], yim),
            "K1-db differs from the model's K1 output")
    del joint_db
    (are, aim, _, k2_ordered), model_blocks = model_calls["k2"]
    acc_db = hf.irfft_packed_db_kernel(are, aim, plan8k, k2_ordered)
    require(torch.equal(acc_db, model_blocks), "K2-db differs from the model's K2 output")
    note(hf.K2_DB, "config 4 accumulated spectra K2-db", acc_db / n8k,
         hf.irfft_packed_plain(are, aim, plan8k, k2_ordered) / n8k, n8k)
    del acc_db

    for n, rows in COMPLEX_DB_SHAPES:
        plan = ct.cached_plan(n, ct.FFT_COMPLEX)
        z = torch.from_numpy(crandn(rng, (rows, n))).to(dev)
        planes = (z.real.contiguous(), z.imag.contiguous())
        for forward in (True, False):
            for ordered in (True, False):
                tag = f"complex N={n} rows={rows} {'fwd' if forward else 'bwd'} {'ord' if ordered else 'unord'}"
                y = hc4.cfft_kernel(z, plan, forward, ordered)
                y_db = hc4.cfft_db_kernel(z, plan, forward, ordered)
                require(torch.equal(y_db, y), f"{tag}: K4-db differs from K4")
                yr, yi = hc4.cfft_db_kernel(planes, plan, forward, ordered)
                require(torch.equal(torch.complex(yr, yi), y), f"{tag}: K4-db planes differ from K4")
                scale = 1.0 if forward else 1.0 / n
                note(hc4.K4_DB, f"{tag} K4-db", y_db * scale, hc4.cfft_plain(z, plan, forward, ordered) * scale, n)
    torch.cuda.synchronize()

    blocks_per_sm = {f"{name} N={n}": lib.hopper_pipelined_blocks_per_sm(which, n)
                     for name, which, sizes in (("K1-db", 1, (4096, 8192, 16384)), ("K2-db", 2, (4096, 8192, 16384)),
                                                ("K4-db", 4, (1024, 4096, 9216, 13824)))
                     for n in sizes}
    zc = torch.from_numpy(crandn(rng, K4_PATH[::-1])).to(dev)
    c_plan = ct.cached_plan(K4_PATH[0], ct.FFT_COMPLEX)
    hf.reset_launch_counts()
    hf.rfft_packed_joint_db_kernel(frames, plan8k, ordered)
    hf.irfft_packed_db_kernel(are, aim, plan8k, k2_ordered)
    hc4.cfft_db_kernel(zc, c_plan, False, True)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in db}
    require(all(v > 0 for v in launches.values()), f"pipelined run launches {launches}")
    log(f"phase 18 ok: K1-db, K2-db, K4-db torch.equal to K1, K2, K4 at every shape (config 4's frames and "
        f"spectra: the model's own outputs; K2-db also at all {len(sweep)} sizes of phase 2's sweep, both orders, "
        f"{', '.join(map(str, (1, *DOMAIN_ROWS[1:])))} rows); worst vs plain " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + "; a zeroed output fails by at least " + ", ".join(f"{r:.0f}x ({k})" for k, r in caught.items())
        + f"; blocks per SM {blocks_per_sm}; pipelined run launches {launches}")
    return worst, launches


def phase19(ct, hf, hc4, roof, row_passes, lib, models, stream, dev, card, audio: np.ndarray, ir: np.ndarray,
            model_calls: dict) -> dict[str, dict]:
    """Timing (informational). Each db kernel beside its grid kernel,
    grid/db/db/grid in turn, at every shape of phase 18 (K1 and K1-db
    joint unordered, K2 unordered, K4 complex64 forward ordered); at the
    headline shape the db kernels' device times and plain versions; K1-K4
    at their paths' shapes; config 4's apply (wall, device time by kernel, idle share) and one
    step (wall); spectrogram (wall, device). Returns each db kernel's row
    at the headline shape (ms, device_ms, plain_ms)."""

    def alternate(grid_fn, db_fn, args):
        g1, d1 = time_ms(grid_fn, args), time_ms(db_fn, args)
        d2, g2 = time_ms(db_fn, args), time_ms(grid_fn, args)
        return (g1 + g2) / 2, (d1 + d2) / 2

    def report(name, shape, grid_ms, db_ms, bound):
        log(f"phase 19 A/B {name} {shape}: grid {grid_ms:.4f} ms, db {db_ms:.4f} ms, db/grid "
            f"{db_ms / grid_ms:.3f}; bound {bound.ms:.4f} ms ({bound.bound_by}) [{card}]")

    def db_times(db_fn, plain, args, host_ms):
        """A db kernel's row: its A/B host-inclusive mean, its device time
        by graph replay, its plain version's time (the library columns are
        its grid kernel's)."""
        return {"ms": host_ms, "device_ms": graph_time_ms(db_fn, args), "plain_ms": time_ms(plain, args)}

    out: dict[str, dict] = {}
    for n, rows in REAL_DB_SHAPES:
        plan = ct.cached_plan(n, ct.FFT_REAL)
        xs = [(torch.randn(rows, n, device=dev),) for _ in range(2)]
        g, d = alternate(lambda v: hf.rfft_packed_joint_kernel(v, plan, False),
                         lambda v: hf.rfft_packed_joint_db_kernel(v, plan, False), xs)
        report("K1 / K1-db", f"N={n} B={rows}", g, d, roof.fft_roofline(n, rows, "real"))
        if (n, rows) == HEADLINE:
            out[hf.K1_DB.name] = db_times(lambda v: hf.rfft_packed_joint_db_kernel(v, plan, False),
                                          lambda v: hf.rfft_packed_joint_plain(v, plan, False), xs, d)
        specs = [hf.rfft_packed_kernel(v, plan, False) for (v,) in xs]
        g, d = alternate(lambda r, i: hf.irfft_packed_kernel(r, i, plan, False),
                         lambda r, i: hf.irfft_packed_db_kernel(r, i, plan, False), specs)
        report("K2 / K2-db", f"N={n} B={rows}", g, d, roof.fft_roofline(n, rows, "real"))
        if (n, rows) == HEADLINE:
            out[hf.K2_DB.name] = db_times(lambda r, i: hf.irfft_packed_db_kernel(r, i, plan, False),
                                          lambda r, i: hf.irfft_packed_plain(r, i, plan, False), specs, d)
        del xs, specs
    (frames, plan8k, ordered), _ = model_calls["k1"]
    (are, aim, _, k2_ordered), _ = model_calls["k2"]
    rows8k = frames.shape[0]
    g, d = alternate(lambda v: hf.rfft_packed_joint_kernel(v, plan8k, ordered),
                     lambda v: hf.rfft_packed_joint_db_kernel(v, plan8k, ordered), [(frames,)])
    report("K1 / K1-db", f"config 4 frames N={plan8k.n} B={rows8k}", g, d, roof.fft_roofline(plan8k.n, rows8k, "real"))
    g, d = alternate(lambda r, i: hf.irfft_packed_kernel(r, i, plan8k, k2_ordered),
                     lambda r, i: hf.irfft_packed_db_kernel(r, i, plan8k, k2_ordered), [(are, aim)])
    report("K2 / K2-db", f"config 4 spectra N={plan8k.n} B={rows8k}", g, d,
           roof.fft_roofline(plan8k.n, rows8k, "real"))
    for n, rows in COMPLEX_DB_SHAPES:
        plan = ct.cached_plan(n, ct.FFT_COMPLEX)
        zs = [(torch.randn(rows, n, dtype=torch.complex64, device=dev),) for _ in range(2)]
        g, d = alternate(lambda v: hc4.cfft_kernel(v, plan, True, True),
                         lambda v: hc4.cfft_db_kernel(v, plan, True, True), zs)
        report("K4 / K4-db", f"N={n} B={rows}", g, d, roof.fft_roofline(n, rows, "complex"))
        if (n, rows) == HEADLINE:
            out[hc4.K4_DB.name] = db_times(lambda v: hc4.cfft_db_kernel(v, plan, True, True),
                                           lambda v: hc4.cfft_plain(v, plan, True, True), zs, d)
        del zs

    # K1-K4 at the shapes their paths give them, each beside its
    # torch.fft call (K3 beside the inverse alone: no single call computes
    # it): config 4's frames and accumulated spectra, the STFT's frames
    # (n_fft 1024 on the same audio), config 3's fir_filter_ols (block
    # 8192: K3 at N=16384 on 512 rows, a shared filter) and its
    # partitioned_fir_apply at block 1024 (K2 at N=2048), the C=1024
    # channelizer's backward transform.
    def irfft_lib(n):
        return lambda c: torch.fft.irfft(c, n=n, norm="forward")

    def spectra(plan, rows):
        """Unordered packed planes of unit-scale rows, and their complex
        spectra for the library call."""
        v = torch.randn(rows, plan.n, device=dev)
        return [hf.rfft_packed_kernel(v, plan, False)], [(torch.fft.rfft(v),)]

    rplan4k = ct.cached_plan(STFT[0], ct.FFT_REAL)
    stft_rows = audio.shape[0] * -(-(audio.shape[1] + STFT[0] - STFT[1]) // STFT[1])  # 64 x 939 frames
    ols_plan = ct.cached_plan(2 * 8192, ct.FFT_REAL)
    ols_rows = CONFIG3["streams"] * CONFIG3["samples"] // 8192
    ols_args, ols_lib = spectra(ols_plan, ols_rows)
    ols_filt = tuple(t[:1].contiguous() for t in spectra(ols_plan, 1)[0][0])
    pfir_plan = ct.cached_plan(2 * 1024, ct.FFT_REAL)
    pfir_args, pfir_lib = spectra(pfir_plan, CONFIG3["streams"] * CONFIG3["samples"] // 1024)
    acc_lib = [(torch.fft.rfft(torch.randn(are.shape[0], plan8k.n, device=dev)),)]
    c_plan = ct.cached_plan(K4_PATH[0], ct.FFT_COMPLEX)
    paths = (
        ("K1 config 4 frames", plan8k, [(frames,)], lambda v: hf.rfft_packed_kernel(v, plan8k, ordered),
         lambda v: hf.rfft_packed_plain(v, plan8k, ordered), lambda v: torch.fft.rfft(v), None),
        ("K2 config 4 accumulated spectra", plan8k, [(are, aim)],
         lambda r, i: hf.irfft_packed_kernel(r, i, plan8k, k2_ordered),
         lambda r, i: hf.irfft_packed_plain(r, i, plan8k, k2_ordered), irfft_lib(plan8k.n), acc_lib),
        ("K1 STFT frames", rplan4k, [(torch.randn(stft_rows, STFT[0], device=dev),)],
         lambda v: hf.rfft_packed_kernel(v, rplan4k), lambda v: hf.rfft_packed_plain(v, rplan4k),
         lambda v: torch.fft.rfft(v), None),
        ("K3 config 3 fir_filter_ols", ols_plan, ols_args,
         lambda r, i: hf.convolve_irfft_packed_kernel(r, i, *ols_filt, 1.0 / ols_plan.n, ols_plan, False),
         lambda r, i: hf.convolve_irfft_packed_plain(r, i, *ols_filt, 1.0 / ols_plan.n, ols_plan, False),
         irfft_lib(ols_plan.n), ols_lib),
        ("K2 config 3 block 1024", pfir_plan, pfir_args, lambda r, i: hf.irfft_packed_kernel(r, i, pfir_plan, False),
         lambda r, i: hf.irfft_packed_plain(r, i, pfir_plan, False), irfft_lib(pfir_plan.n), pfir_lib),
        ("K4 channelizer backward", c_plan, [(torch.randn(K4_PATH[1], K4_PATH[0], dtype=torch.complex64, device=dev),)],
         lambda v: hc4.cfft_kernel(v, c_plan, False, True), lambda v: hc4.cfft_plain(v, c_plan, False, True),
         lambda v: torch.fft.ifft(v, norm="forward"), None),
    )
    for name, plan, args, fn, plain, library, library_args in paths:
        rows = args[0][0].shape[0]
        tm = kernel_times(fn, plain, args, library, library_args)
        out[name] = tm
        g = row_passes.launch_geometry(plan, rows)
        which = 2 if name.startswith("K2") else 3 if name.startswith("K3") else 1
        blocks = (lib.hopper_real_fft_blocks_per_sm(which, g.threads, g.smem_bytes) if plan.kind == ct.FFT_REAL
                  else lib.hopper_complex_fft_blocks_per_sm(g.threads, g.smem_bytes))
        bound = roof.fft_roofline(plan.n, rows, plan.kind)
        log_times(19, name, f"N={plan.n} B={rows}", tm, card)
        log(f"phase 19 {name}: device/bound {tm['device_ms'] / bound.ms:.2f}, device/library "
            f"{tm['device_ms'] / tm['library_device_ms']:.2f}; geometry {g.passes}, {g.rows_per_block} rows and "
            f"{g.threads} threads a block, {g.smem_bytes} B; {blocks} resident blocks per SM")
    del paths, ols_args, ols_lib, pfir_args, pfir_lib, acc_lib

    channels, t = audio.shape
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=channels, block=CONFIG4_BLOCK), device=dev)
    x = torch.from_numpy(audio).to(dev)

    apply_wall = wall_ms(lambda: conv.apply(x), 5)
    breakdown(19, f"config 4 apply ({channels} ch x {t} samples, block {CONFIG4_BLOCK})", lambda: conv.apply(x),
              apply_wall, card, top=14)
    state = conv.init_state()
    frame = x[:, :CONFIG4_BLOCK]
    step_wall = wall_ms(lambda: conv.step(state, frame), 7)
    breakdown(19, f"config 4 step ({channels} x {CONFIG4_BLOCK})", lambda: conv.step(state, frame), step_wall,
              card, top=6)
    n_fft, hop = STFT
    spec_wall = wall_ms(lambda: stream.spectrogram(x, n_fft=n_fft, hop=hop), 5)
    breakdown(19, f"spectrogram (n_fft {n_fft}, hop {hop}, {channels} x {t})",
              lambda: stream.spectrogram(x, n_fft=n_fft, hop=hop), spec_wall, card)
    spec = stream.stft(x, n_fft=n_fft, hop=hop)
    istft_wall = wall_ms(lambda: stream.istft(spec, hop=hop, length=t), 5)
    breakdown(19, f"istft (n_fft {n_fft}, hop {hop}, {channels} x {spec.shape[-2]} frames)",
              lambda: stream.istft(spec, hop=hop, length=t), istft_wall, card)
    return out



# ---------------------------------------------------------------------------
# Phase 20: gradients on the card (ops/autodiff.py)
# ---------------------------------------------------------------------------

ADJOINT_RTOL = 1e-6  # <J v, u> against <v, J^T u> over the operand norms (test_autodiff.py)
SLOT0_RTOL = 1e-5  # the slot-0 closed forms, over N times the cotangent's largest value
GRAD_REAL = ((4096, 1024, True), (4096, 1024, False), (256, 32768, True), (576, 64, True), (1 << 20, 64, True))
GRAD_COMPLEX = ((4096, 1024), (256, 32768), (1 << 20, 64))
GRAD_CONV = (16384, 512)  # config 3's fir_filter_ols(block=8192): K3 on 512 rows of 16384
TRAIN_STEPS = {"config 3": 5, "reverb": 3}
TRAIN_LR = 0.1  # Adam's step over the mean |h*|: small against the error each tap starts with
GRAD_ENGINE_RTOL = 1e-4  # a gradient against the Stockham engine's, over its largest value (_grad_match)
PLAIN_ROWS = 8  # rows of a complex composite held against the plain route


def dot64(a, b) -> float:
    """The real inner product of two tensors or two tuples of planes, in
    float64 on the card (complex: Re sum(conj(a) b))."""
    pairs = zip(a, b) if isinstance(a, tuple) else ((a, b),)
    total = 0.0
    for p, q in pairs:
        if p.is_complex():
            p, q = torch.view_as_real(p), torch.view_as_real(q)
        total += float((p.double() * q.double()).sum())
    return total


def norm64(a) -> float:
    return float(np.sqrt(sum(float(t.abs().double().pow(2).sum()) for t in (a if isinstance(a, tuple) else (a,)))))


def counted_grad(hf, out, inputs, cot, backward: dict[str, int]) -> tuple:
    """torch.autograd.grad of ``out`` along ``cot``, with every launch
    count reset just before and read just after; adds them to
    ``backward``."""
    torch.cuda.synchronize()
    hf.reset_launch_counts()
    grads = torch.autograd.grad(out if isinstance(out, tuple) else (out,), inputs, cot)
    torch.cuda.synchronize()
    for k in hf.KERNELS:
        backward[k.name] = backward.get(k.name, 0) + k.launches
    return grads, {k.name: k.launches for k in hf.KERNELS if k.launches}


@contextlib.contextmanager
def slot0_weight_wrong(autodiff):
    """The half-spectrum weight applied to slot 0 as to the paired bins: a
    wrong rule the slot-0 closed forms must catch."""
    right = autodiff.halfspec_weight
    autodiff.halfspec_weight = lambda re, im, w: (re * w, im * w)
    try:
        yield
    finally:
        autodiff.halfspec_weight = right


def alternating_sum(t: torch.Tensor) -> torch.Tensor:
    """sum_n (-1)^n t[..., n] in float64 (the Nyquist bin's projection)."""
    d = t.double()
    return d[..., 0::2].sum(-1) - d[..., 1::2].sum(-1)


def phase20_functions(ct, hf, hs, hc, autodiff, dev, seed: int) -> tuple[dict[str, int], dict[str, float]]:
    """Each autograd Function on the card, checked three ways at the
    table's shapes: against the same Function on the plain versions (2e-7*N
    times the cotangent's largest value, twice that where the rule weights
    by 2; the plain gradient's largest value for K3's), against float64
    (the adjoint identity in float64, relative 1e-6; the slot-0 closed
    forms, relative 1e-5; Parseval's closed form of
    test_pallas_engine.py:383-400 for RfftPacked), and by the kernels its
    backward launched (> 0). A zeroed gradient must fail the plain check
    and the adjoint identity; a half weight applied to slot 0 must fail
    the slot-0 forms. Returns the backward launches and each check's
    worst ratio to its bound."""
    backward: dict[str, int] = {}
    worst: dict[str, float] = {}
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):  # made on the card from the seed: numpy takes seconds at 2^26 values
        return torch.randn(*shape, device=dev, generator=gen)

    def held_to(key, err, bound):
        require(err <= bound, f"phase 20 {key}: {err:.3e} > {bound:.3e}")
        kind = " ".join(key.split()[:2])  # the Function and the check
        worst[kind] = max(worst.get(kind, 0.0), err / bound)

    def caught(key, err, bound):
        require(err > bound, f"phase 20 {key}: the wrong gradient passes ({err:.3e} <= {bound:.3e})")
        return err / bound

    def expect_launched(key, launches, kernels):
        for k in kernels:
            require(launches.get(k.name, 0) > 0, f"phase 20 {key}: {k.name} was not launched in backward")

    def real_kernels(n, inverse_rule):
        """What RfftPacked's backward (``inverse_rule``) or IrfftPacked's launches at N."""
        if hs.in_domain(n):
            return [hs.K5_REAL_INVERSE if inverse_rule else hs.K5_REAL]
        if hf._in_domain(n):
            return [hf.K2 if inverse_rule else hf.K1]
        return [hc.K7B, hc.K6_L2_REV] if inverse_rule else [hc.K7A, hc.K6_L2]

    for n, rows, ordered in GRAD_REAL:
        tag = f"N={n} B={rows} {'ordered' if ordered else 'unordered'}"
        plan = ct.cached_plan(n, ct.FFT_REAL)
        x = randn(rows, n)
        u = (randn(rows, n // 2), randn(rows, n // 2))
        umax = max(float(t.abs().max()) for t in u)

        # RfftPacked: x -> planes; backward the inverse of the half-weighted cotangent.
        v = x.clone().requires_grad_()
        y = autodiff.RfftPacked.apply(v, plan, ordered, False)
        (g,), launches = counted_grad(hf, y, [v], u, backward)
        expect_launched(f"RfftPacked {tag}", launches, real_kernels(n, True))
        vp = x.clone().requires_grad_()
        (gp,), _ = counted_grad(hf, autodiff.RfftPacked.apply(vp, plan, ordered, True), [vp], u, {})
        bound = TOL * n * umax
        held_to(f"RfftPacked plain {tag}", max_err(g, gp), bound)
        caught(f"RfftPacked plain {tag} zeroed", max_err(torch.zeros_like(g), gp), bound)
        y = tuple(t.detach() for t in y)
        scale = norm64(y) * norm64(u)
        held_to(f"RfftPacked adjoint {tag}", abs(dot64(y, u) - dot64(x, g)) / scale, ADJOINT_RTOL)
        caught(f"RfftPacked adjoint {tag} zeroed", abs(dot64(y, u) - 0.0) / scale, ADJOINT_RTOL)

        def slot0_real(grad):
            return max(float((grad.double().sum(-1) - n * u[0][:, 0].double()).abs().max()),
                       float((alternating_sum(grad) - n * u[1][:, 0].double()).abs().max())) / (n * umax)

        held_to(f"RfftPacked slot-0 {tag}", slot0_real(g), SLOT0_RTOL)
        with slot0_weight_wrong(autodiff):
            vb = x.clone().requires_grad_()
            (gb,), _ = counted_grad(hf, autodiff.RfftPacked.apply(vb, plan, ordered, False), [vb], u, {})
        slot0_caught = caught(f"RfftPacked slot-0 {tag} half weight", slot0_real(gb), SLOT0_RTOL)
        # Parseval: sum re^2 + im^2 has gradient N*x + X_0 + (-1)^j X_{N/2}.
        vq = x.clone().requires_grad_()
        yq = autodiff.RfftPacked.apply(vq, plan, ordered, False)
        (gq,), _ = counted_grad(hf, yq, [vq], tuple(2 * t.detach() for t in yq), backward)
        signs = torch.ones(n, dtype=torch.float64, device=dev)
        signs[1::2] = -1
        want = n * x.double() + x.double().sum(-1, keepdim=True) + signs * alternating_sum(x)[:, None]
        xmax = max(float(torch.hypot(y[0][:, 1:], y[1][:, 1:]).max()), float(y[0][:, 0].abs().max()),
                   float(y[1][:, 0].abs().max()))
        held_to(f"RfftPacked Parseval {tag}", float((gq.double() - want).abs().max()), TOL * n * 2.0 * xmax)
        log(f"phase 20 RfftPacked {tag}: plain {max_err(g, gp):.3e} (bound {bound:.3e}), adjoint "
            f"{abs(dot64(y, u) - dot64(x, g)) / scale:.2e}, slot 0 {slot0_real(g):.2e} (a half weight there: "
            f"{slot0_caught:.3g}x its bound); backward launches {launches}")

        # IrfftPacked: planes -> x; backward the forward of the cotangent, weighted 2.
        w = randn(rows, n)
        wmax = float(w.abs().max())
        s = tuple(t.clone().requires_grad_() for t in y)
        out = autodiff.IrfftPacked.apply(*s, plan, ordered, False)
        g, launches = counted_grad(hf, out, list(s), (w,), backward)
        expect_launched(f"IrfftPacked {tag}", launches, real_kernels(n, False))
        sp = tuple(t.clone().requires_grad_() for t in y)
        gp, _ = counted_grad(hf, autodiff.IrfftPacked.apply(*sp, plan, ordered, True), list(sp), (w,), {})
        bound = 2 * TOL * n * wmax
        err = max(max_err(a, b) for a, b in zip(g, gp))
        held_to(f"IrfftPacked plain {tag}", err, bound)
        caught(f"IrfftPacked plain {tag} zeroed", max(max_err(torch.zeros_like(b), b) for b in gp), bound)
        out = out.detach()
        scale = norm64(out) * norm64(w)
        adj = abs(dot64(out, w) - dot64(y, tuple(g))) / scale
        held_to(f"IrfftPacked adjoint {tag}", adj, ADJOINT_RTOL)
        caught(f"IrfftPacked adjoint {tag} zeroed", abs(dot64(out, w)) / scale, ADJOINT_RTOL)

        def slot0_inv(grad):
            return max(float((grad[0][:, 0].double() - w.double().sum(-1)).abs().max()),
                       float((grad[1][:, 0].double() - alternating_sum(w)).abs().max())) / (n * wmax)

        held_to(f"IrfftPacked slot-0 {tag}", slot0_inv(g), SLOT0_RTOL)
        with slot0_weight_wrong(autodiff):
            sb = tuple(t.clone().requires_grad_() for t in y)
            gb, _ = counted_grad(hf, autodiff.IrfftPacked.apply(*sb, plan, ordered, False), list(sb), (w,), {})
        slot0_caught = caught(f"IrfftPacked slot-0 {tag} weight 2", slot0_inv(gb), SLOT0_RTOL)
        log(f"phase 20 IrfftPacked {tag}: plain {err:.3e} (bound {bound:.3e}), adjoint {adj:.2e}, slot 0 "
            f"{slot0_inv(g):.2e} (weight 2 there: {slot0_caught:.3g}x its bound); backward launches {launches}")
        del x, u, y, v, vp, vq, yq, g, gp, gb, gq, want, w, s, sp, sb, out

    # ConvolveIrfftPacked at config 3's shape, a shared and a batched B.
    n, rows = GRAD_CONV
    plan = ct.cached_plan(n, ct.FFT_REAL)
    a = hf.rfft_rows(randn(rows, n), plan, False)
    w = randn(rows, n)
    for b_rows in (1, rows):
        tag = f"N={n} B={rows}, B rows {b_rows}"
        hb = randn(b_rows, n) / n ** 0.5
        b = hf.rfft_rows(hb, plan, False)
        args = [t.clone().requires_grad_() for t in (*a, *b)]
        out = autodiff.ConvolveIrfftPacked.apply(*args, plan, 1.0 / n, False, False)
        g, launches = counted_grad(hf, out, args, (w,), backward)
        expect_launched(f"ConvolveIrfftPacked {tag}", launches, [hf.K1])
        argp = [t.clone().requires_grad_() for t in (*a, *b)]
        gp, _ = counted_grad(hf, autodiff.ConvolveIrfftPacked.apply(*argp, plan, 1.0 / n, False, True), argp,
                             (w,), {})
        err = max(max_err(p, q) / (TOL * n * float(q.abs().max())) for p, q in zip(g, gp))
        held_to(f"ConvolveIrfftPacked plain {tag}", err, 1.0)
        caught(f"ConvolveIrfftPacked plain {tag} zeroed",
               max(max_err(torch.zeros_like(q), q) / (TOL * n * float(q.abs().max())) for q in gp), 1.0)
        out = out.detach()
        scale = norm64(out) * norm64(w)
        adj = max(abs(dot64(out, w) - dot64(a, tuple(g[:2]))), abs(dot64(out, w) - dot64(b, tuple(g[2:])))) / scale
        held_to(f"ConvolveIrfftPacked adjoint {tag}", adj, ADJOINT_RTOL)
        caught(f"ConvolveIrfftPacked adjoint {tag} zeroed", abs(dot64(out, w)) / scale, ADJOINT_RTOL)
        sw, aw = w.double().sum(-1), alternating_sum(w)
        b0 = max(float(b[0][:, 0].abs().max()), float(b[1][:, 0].abs().max()))

        def slot0_conv(grad):
            want_re, want_im = b[0][:, 0].double() * sw / n, b[1][:, 0].double() * aw / n
            return max(float((grad[0][:, 0].double() - want_re).abs().max()),
                       float((grad[1][:, 0].double() - want_im).abs().max())) / (b0 * float(w.abs().max()))

        held_to(f"ConvolveIrfftPacked slot-0 {tag}", slot0_conv(g), SLOT0_RTOL)
        with slot0_weight_wrong(autodiff):
            argb = [t.clone().requires_grad_() for t in (*a, *b)]
            gb, _ = counted_grad(hf, autodiff.ConvolveIrfftPacked.apply(*argb, plan, 1.0 / n, False, False), argb,
                                 (w,), {})
        slot0_caught = caught(f"ConvolveIrfftPacked slot-0 {tag} weight 2", slot0_conv(gb), SLOT0_RTOL)
        log(f"phase 20 ConvolveIrfftPacked {tag}: plain {err:.3e} of its bound, adjoint {adj:.2e}, slot 0 "
            f"{slot0_conv(g):.2e} (weight 2 there: {slot0_caught:.3g}x its bound); backward launches {launches}")
        del args, argp, argb, out, g, gp, gb
    del a, w

    # CfftPair: both directions, planes and complex64 (K4 also unordered).
    cases = [(n, rows, fwd, planes, True) for n, rows in GRAD_COMPLEX for fwd in (True, False)
             for planes in (True, False)] + [(*GRAD_COMPLEX[0], True, False, False)]
    for n, rows, fwd, planes, ordered in cases:
        tag = (f"N={n} B={rows} {'forward' if fwd else 'backward'} {'planes' if planes else 'complex64'}"
               f"{'' if ordered else ' unordered'}")
        plan = ct.cached_plan(n, ct.FFT_COMPLEX)
        z = torch.complex(randn(rows, n), randn(rows, n))
        u = torch.complex(randn(rows, n), randn(rows, n))
        if hs.in_domain(n):
            kernels = [hs.K5_COMPLEX]
        elif n <= hf.MAX_CN:
            kernels = [hf.K4]
        else:
            kernels = [hc.K6_L2_REV, hc.K6_L1_REV] if fwd else [hc.K6_L1, hc.K6_L2]
        inputs = (z.real.contiguous(), z.imag.contiguous()) if planes else (z,)
        cot = (u.real.contiguous(), u.imag.contiguous()) if planes else (u,)

        def run(plain, r):
            args = [t[:r].clone().requires_grad_() for t in inputs]
            out = autodiff.CfftPair.apply(args[0], args[1] if planes else None, plan, fwd, ordered, plain)
            grads, launches = counted_grad(hf, out, args, tuple(t[:r] for t in cot), backward if not plain else {})
            return (tuple(t.detach() for t in out) if planes else out.detach()), grads, launches

        out, g, launches = run(False, rows)
        expect_launched(f"CfftPair {tag}", launches, kernels)
        # Rows are independent: at the composite sizes the plain route (a
        # Stockham composite of many small ops) takes PLAIN_ROWS of them.
        r = rows if n <= hf.MAX_CN else PLAIN_ROWS
        _, gp, _ = run(True, r)
        bound = TOL * n * float(torch.view_as_real(u).abs().max())
        err = max(max_err(p[:r], q) for p, q in zip(g, gp))
        held_to(f"CfftPair plain {tag}", err, bound)
        caught(f"CfftPair plain {tag} zeroed", max(max_err(torch.zeros_like(q), q) for q in gp), bound)
        scale = norm64(out) * norm64(u)
        adj = abs(dot64(out, cot if planes else u) - dot64(inputs if planes else z, tuple(g) if planes else g[0]))
        held_to(f"CfftPair adjoint {tag}", adj / scale, ADJOINT_RTOL)
        caught(f"CfftPair adjoint {tag} zeroed", abs(dot64(out, cot if planes else u)) / scale, ADJOINT_RTOL)
        log(f"phase 20 CfftPair {tag}: plain {err:.3e} (bound {bound:.3e}), adjoint {adj / scale:.2e}; backward "
            f"launches {launches}")
        del z, u, inputs, cot, out, g, gp
    torch.cuda.empty_cache()
    return backward, worst


def phase20_timing(ct, hf, autodiff, dev, card) -> None:
    """Device time (torch.profiler, device events) of one forward and one
    backward of each Function at the headline shape (unordered, as the
    stream layer runs it) and at config 2's top row, the backward split
    into the port's kernels and the plain-torch glue (PyTorch's own
    ``at::native`` kernels), and the backward/forward ratio."""
    def one(name, fn, inputs, cot):
        args = [t.clone().requires_grad_() for t in inputs]
        out = fn(*args)
        torch.autograd.grad(out, args, cot, retain_graph=True)  # warm-up
        torch.cuda.synchronize()
        fwd = kernel_device_times(lambda: fn(*args))
        bwd = kernel_device_times(lambda: torch.autograd.grad(out, args, cot, retain_graph=True))
        glue = sum(v for k, v in bwd.items() if "at::native" in k)
        f_ms, b_ms = sum(fwd.values()), sum(bwd.values())
        log(f"phase 20 timing {name}: forward {f_ms:.4f} ms, backward {b_ms:.4f} ms (port kernels "
            f"{b_ms - glue:.4f}, glue {glue:.4f}), backward/forward {b_ms / f_ms:.3f} (device, profiler) [{card}]")

    gen = torch.Generator(device=dev).manual_seed(20)
    for n, rows, ordered in ((4096, 1024, False), (1 << 20, 64, True)):
        plan = ct.cached_plan(n, ct.FFT_REAL)
        x = torch.randn(rows, n, device=dev, generator=gen)
        u = tuple(torch.randn(rows, n // 2, device=dev, generator=gen) for _ in range(2))
        one(f"RfftPacked N={n} B={rows}", lambda v: autodiff.RfftPacked.apply(v, plan, ordered, False), [x], u)
        spec = hf.rfft_rows(x, plan, ordered)
        one(f"IrfftPacked N={n} B={rows}", lambda a, b: autodiff.IrfftPacked.apply(a, b, plan, ordered, False),
            list(spec), (x,))
        cplan = ct.cached_plan(n, ct.FFT_COMPLEX)
        z = torch.complex(x, torch.randn(rows, n, device=dev, generator=gen))
        one(f"CfftPair N={n} B={rows} forward complex64",
            lambda a: autodiff.CfftPair.apply(a, None, cplan, True, True, False), [z], (z,))
        del x, u, spec, z
    n, rows = GRAD_CONV
    plan = ct.cached_plan(n, ct.FFT_REAL)
    a = hf.rfft_rows(torch.randn(rows, n, device=dev, generator=gen), plan, False)
    b = hf.rfft_rows(torch.randn(1, n, device=dev, generator=gen) / n ** 0.5, plan, False)
    one(f"ConvolveIrfftPacked N={n} B={rows} shared B",
        lambda *t: autodiff.ConvolveIrfftPacked.apply(*t, plan, 1.0 / n, False, False), [*a, *b],
        (torch.randn(rows, n, device=dev, generator=gen),))
    torch.cuda.empty_cache()


def fft_convolve64_card(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The float64 FFT convolution of float32 streams with filters, on the
    card (``torch.fft`` in float64: a reference, not the port), truncated
    to the streams' length."""
    t, taps = x.shape[-1], h.shape[-1]
    nfft = 1 << (t + taps - 2).bit_length()
    spec = torch.fft.rfft(x.double(), nfft) * torch.fft.rfft(h.double(), nfft)
    return torch.fft.irfft(spec, nfft)[..., :t]


def xcorr64(r: np.ndarray, x: np.ndarray, taps: int) -> np.ndarray:
    """sum_t r[..., t] x[..., t - k] for k < taps, float64 numpy FFTs: the
    gradient of sum(r * (x * h)) with respect to h."""
    nfft = 1 << (r.shape[-1] + taps - 1).bit_length()
    return np.fft.irfft(np.fft.rfft(r, nfft) * np.conj(np.fft.rfft(x, nfft)), nfft)[..., :taps]


def learn_ir(hf, stream, name: str, x: torch.Tensor, target: torch.Tensor, h_star: torch.Tensor, steps: int,
             block, card: str, check_rows: int) -> dict:
    """Fit an impulse response with Adam from zero: loss = mean((fir_filter_ols(x, h) - target)^2), target
    the float64 convolution with ``h_star``. Each step's wall (host clock after synchronize) and its
    backward's launches; after each step a forward and a backward at the new h (not applied) under
    torch.profiler for the device time by kernel. The first gradient against the same call on the
    Stockham engine and against float64 (the cross-correlation of the residual with x, numpy, on
    ``check_rows`` streams): 2e-7*N of the float64 gradient's largest value, the engine's bound for
    one N-point transform chain relative to its scale. The loss must fall at every step."""
    kw = {} if block is None else {"block": block}
    taps = h_star.shape[-1]
    n = stream.next_fft_size((block or max(256, stream.next_fft_size(4 * taps) // 2)) + taps - 1)

    def loss_of(param, engine="auto"):
        y = stream.fir_filter_ols(x, param, engine=engine, **kw)
        return ((y - target) ** 2).mean(), y

    h = torch.nn.Parameter(torch.zeros_like(h_star))
    lr = TRAIN_LR * float(h_star.abs().mean())
    opt = torch.optim.Adam([h], lr=lr)
    losses, walls, ratios, backward = [], [], [], {}
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, y = loss_of(h)
        hf.reset_launch_counts()
        loss.backward()
        launches = {k.name: k.launches for k in hf.KERNELS if k.launches}
        opt.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        for k, v in launches.items():
            backward[k] = backward.get(k, 0) + v
        if step == 0:
            g = h.grad.detach().clone()
            h0 = torch.zeros_like(h_star, requires_grad=True)
            (gs,) = torch.autograd.grad(loss_of(h0, "stockham")[0], h0)
            r = (y.detach()[:check_rows] - target[:check_rows]).double().cpu().numpy()
            x64 = x[:check_rows].double().cpu().numpy()
            g64 = xcorr64(r, x64, h_star.shape[-1]) * (2.0 / y.numel())
            if h_star.ndim == 1:
                g64 = g64.sum(0)
                g_rows, gs_rows = g, gs
            else:
                g_rows, gs_rows = g[:check_rows], gs[:check_rows]
            scale = float(np.abs(g64).max())
            err64, err_s = max_err(g_rows, g64), max_err(g_rows, gs_rows)
            bound = TOL * n * scale
            log(f"phase 20 {name} (N={n}) first gradient: vs float64 {err64:.3e}, vs engine=stockham {err_s:.3e} "
                f"(bound 2e-7*N*max|g64| = {bound:.3e}; max|g64| {scale:.3e}); backward launches {launches}")
            require(err64 <= bound and err_s <= bound, f"{name}: the first gradient is off ({err64}, {err_s})")
            require(max_err(torch.zeros_like(g_rows), g64) > bound, f"{name}: a zeroed gradient passes")
            del y, gs, g, r, x64
        fwd = kernel_device_times(lambda: loss_of(h))
        loss_p, _ = loss_of(h)
        bwd = kernel_device_times(lambda: torch.autograd.grad(loss_p, h))
        del loss_p
        f_ms, b_ms = sum(fwd.values()), sum(bwd.values())
        ratios.append(b_ms / f_ms)
        log(f"phase 20 {name} step {step + 1}: loss {losses[-1]:.9e}, wall {walls[-1]:.3f} ms (host clock after "
            f"synchronize); device forward {f_ms:.3f} ms, backward {b_ms:.3f} ms, backward/forward "
            f"{b_ms / f_ms:.3f}, idle share {1 - (f_ms + b_ms) / walls[-1]:.3f} (Adam's update not profiled); "
            f"backward launches {launches} [{card}]")
        for kname, ms in sorted(bwd.items(), key=lambda kv: -kv[1])[:6]:
            log(f"  backward {ms:9.4f} ms  {kname[:100]}")
    with torch.no_grad():
        losses.append(float(loss_of(h)[0]))
    log(f"phase 20 {name}: losses {', '.join(f'{v:.9e}' for v in losses)} (lr {lr:.3e})")
    require(all(b < a for a, b in zip(losses, losses[1:])), f"{name}: the loss did not fall at every step {losses}")
    return {"backward": backward, "walls": walls, "ratios": ratios, "losses": losses}


def phase20_training(hf, stream, models, dev, rng, card, x3, h3, ref3: np.ndarray, audio: np.ndarray,
                     ir: np.ndarray) -> dict[str, int]:
    """The training slice at full width: a learned impulse response fitted
    with Adam on config 3's streams (4 x 2^20, 4096 taps, block 8192: K1 +
    K3 forward, K1 + K2 backward; 5 steps) and on the reverb (64 ch x 10 s,
    2 s per-channel IRs, N = 2^19: the composite both ways; 3 steps), the
    targets the float64 convolutions with phase 3's filter and the
    reverb's IRs; then config 4's ``MultichannelConvolver.apply``
    differentiated with respect to x (K1/K2 at N = 8192, P = 24), 8
    channels against the model on the Stockham engine (rtol 1e-4 of its
    largest value, as _grad_match). Returns the backward launches."""
    backward: dict[str, int] = {}
    t0 = time.perf_counter()
    run = learn_ir(hf, stream, "config 3", x3, torch.from_numpy(ref3.astype(np.float32)).to(dev), h3,
                   TRAIN_STEPS["config 3"], 8192, card, x3.shape[0])
    for k in (hf.K1, hf.K2):
        require(run["backward"].get(k.name, 0) > 0, f"config 3 training: {k.name} was not launched in backward")
    for k, v in run["backward"].items():
        backward[k] = backward.get(k, 0) + v
    log(f"phase 20 config 3 training ok in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    x = torch.from_numpy(audio).to(dev)
    h_star = torch.from_numpy(ir).to(dev)
    target = fft_convolve64_card(x, h_star).float()
    run = learn_ir(hf, stream, "reverb", x, target, h_star, TRAIN_STEPS["reverb"], None, card, 8)
    from chowdsp_fft_tpu_torch.ops import hopper_composite as hc
    for k in (hc.K7A, hc.K6_L2, hc.K6_L2_REV, hc.K7B):
        require(run["backward"].get(k.name, 0) > 0, f"reverb training: {k.name} was not launched in backward")
    for k, v in run["backward"].items():
        backward[k] = backward.get(k, 0) + v
    del target
    log(f"phase 20 reverb training ok in {time.perf_counter() - t0:.1f} s")

    # Config 4: the gradient of MultichannelConvolver.apply with respect to x.
    t0 = time.perf_counter()
    channels = audio.shape[0]
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=channels, block=CONFIG4_BLOCK), device=dev)
    w = torch.from_numpy(rng.standard_normal(audio.shape, dtype=np.float32)).to(dev)
    xv = x.clone().requires_grad_()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss = (conv.apply(xv) * w).sum()
    hf.reset_launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) * 1e3
    launches = {k.name: k.launches for k in hf.KERNELS if k.launches}
    for k in (hf.K1, hf.K2):
        require(launches.get(k.name, 0) > 0, f"config 4 gradient: {k.name} was not launched in backward")
    for k, v in launches.items():
        backward[k] = backward.get(k, 0) + v
    conv8 = models.MultichannelConvolver(ir[:8], models.ConvolverConfig(channels=8, block=CONFIG4_BLOCK,
                                                                        engine="stockham"), device=dev)
    x8 = x[:8].clone().requires_grad_()
    (conv8.apply(x8) * w[:8]).sum().backward()
    err = max_err(xv.grad[:8], x8.grad) / float(x8.grad.abs().max())
    log(f"phase 20 config 4 dL/dx ({channels} ch x {audio.shape[1]}): forward+backward wall {wall:.3f} ms (first "
        f"call, host clock); 8 channels vs engine=stockham {err:.3e} of its largest value (rtol "
        f"{GRAD_ENGINE_RTOL}); backward launches {launches} [{card}]")
    require(err <= GRAD_ENGINE_RTOL, f"config 4 gradient vs stockham: {err} > {GRAD_ENGINE_RTOL}")
    require(bool(torch.isfinite(xv.grad).all()), "config 4 gradient: non-finite values")
    del conv, conv8, xv, x8, w, loss, x
    torch.cuda.empty_cache()
    log(f"phase 20 config 4 gradient ok in {time.perf_counter() - t0:.1f} s")
    return backward


# ---------------------------------------------------------------------------
# Phase 21: the parallel layer on a one-rank NCCL group
# ---------------------------------------------------------------------------

DIST_BIG = (1 << 24, 2)  # one rank splits it A = C = 4096, above the single-card composite's 2^20
DIST_CONV_ROWS = 8  # the circular convolutions at N = 2^20
SHARDED_ATOL = 1e-4  # a sharded model form vs its unsharded call (test_parallel.py's SDR tolerance)
DIST_REAL_CONV_RTOL = 4e-6  # of the reference's peak (test_parallel.py)
DIST_COMPLEX_CONV_RTOL = 1e-4


def held_dist(got: torch.Tensor, want: torch.Tensor, n: int) -> float:
    """max |got - want| over the 2e-7*N bound (at most 1 to pass)."""
    return max_err(got, want) / (TOL * n)


def dist_fft_checks(parallel, mesh, dev, n: int, rows: int, seed: int) -> dict[str, float]:
    """The distributed FFT at (n, rows) on the mesh against float64 (on the
    card up to 2^20, numpy's on the host above), through spectrum_order /
    rspectrum_order, and the round trips; a zeroed output and a real
    spectrum without its DC/Nyquist slots must fail."""
    import scipy.fft

    g = torch.Generator(device=dev).manual_seed(seed)
    re, im = (torch.randn(rows, n, device=dev, generator=g) for _ in range(2))
    x = torch.randn(rows, n, device=dev, generator=g)
    on_host = n > CONFIG2_TOP[0]
    perm = torch.from_numpy(parallel.spectrum_order(n, 1)).to(dev)
    rperm = torch.from_numpy(parallel.rspectrum_order(n, 1)).to(dev)
    fr, fi = (t.to_local() for t in parallel.sharded_fft_planes(re, im, mesh))
    br, bi = (t.to_local() for t in parallel.sharded_ifft_planes(fr, fi, mesh))
    rr, ri = (t.to_local() for t in parallel.sharded_rfft_planes(x, mesh))
    xb = parallel.sharded_irfft_planes(rr, ri, mesh, n).to_local()
    torch.cuda.synchronize()
    valid = rperm >= 0
    if on_host:  # numpy float64 (scipy's pocketfft, one worker a row)
        z64 = torch.complex(re, im).cpu().numpy().astype(np.complex128)
        spec = torch.from_numpy(scipy.fft.fft(z64, axis=-1, workers=-1)).to(dev)
        half = torch.from_numpy(scipy.fft.rfft(x.double().cpu().numpy(), axis=-1, workers=-1)).to(dev)
        idx = rperm[valid]
        rspec = torch.where(idx <= n // 2, half[:, idx.clamp(max=n // 2)], half[:, (n - idx).clamp(max=n // 2)].conj())
    else:
        spec = torch.fft.fft(torch.complex(re.double(), im.double()))
        rspec = torch.fft.fft(x.double())[:, rperm[valid]]
    want = spec[:, perm]
    got = torch.complex(fr, fi)
    rgot = torch.complex(rr, ri)
    errs = {
        "fft": held_dist(got, want, n),
        "ifft": held_dist(torch.complex(br, bi) / n, torch.complex(re, im), n),
        "rfft": held_dist(rgot[:, valid], rspec, n),
        "rfft padding": float(rgot[:, ~valid].abs().max()) if bool((~valid).any()) else 0.0,
        "irfft": held_dist(xb / n, x, n),
    }
    dc_nyq = (rperm[valid] == 0) | (rperm[valid] == n // 2)
    broken = {"zeroed fft": held_dist(torch.zeros_like(got), want, n),
              "rfft without its DC/Nyquist slots": held_dist(rgot[:, valid] * ~dc_nyq, rspec, n)}
    tag = f"N=2^{n.bit_length() - 1}, B={rows}"
    log(f"phase 21 distributed FFT {tag} (split {parallel.dist_fft._dist_split(n, 1)}; float64 "
        f"{'numpy on the host' if on_host else 'on the card'}): share of the 2e-7*N bound "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + "; must fail: " + ", ".join(f"{k} {v:.3e}" for k, v in broken.items()))
    for key, v in errs.items():
        require(v <= (0.0 if key == "rfft padding" else 1.0), f"phase 21 {tag} {key}: {v:.3e}")
    for key, v in broken.items():
        require(v > 1.0, f"phase 21 {tag}: the check passes a {key} ({v:.3e})")
    return errs


def phase21(hf, hs, convolve, models, stream, roof, dev, card, x3, h3, ref3: np.ndarray, audio: np.ndarray,
            ir: np.ndarray, capture: np.ndarray) -> dict[str, int]:
    """The parallel layer's paths on a one-rank NCCL group (a dsp_mesh(1) on
    the card): every local transform runs K1-K5 at full width, the halo
    hop has no operations and each all_to_all is a copy. Returns the
    kernels' launches on these paths."""
    import torch.distributed as dist
    from chowdsp_fft_tpu_torch import parallel

    t_phase = time.perf_counter()
    parallel.init_local_group("cuda")
    try:
        launches = phase21_paths(parallel, hf, hs, convolve, models, stream, roof, dev, card, x3, h3, ref3, audio, ir,
                                 capture)
    finally:
        dist.destroy_process_group()
    log(f"phase 21 ok in {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


def phase21_paths(parallel, hf, hs, convolve, models, stream, roof, dev, card, x3, h3, ref3, audio, ir,
                  capture) -> dict[str, int]:
    from chowdsp_fft_tpu_torch.ops import polyphase

    mesh = parallel.dsp_mesh(1)
    cmesh = parallel.dsp_mesh(1, axis=parallel.CHANNEL_AXIS)
    require(mesh.device_type == "cuda" and mesh.size() == 1, f"mesh {mesh}")
    kernels = hf.KERNELS + convolve.KERNELS + polyphase.KERNELS
    launches = {k.name: 0 for k in kernels}

    def counted(name: str, fn):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in kernels if k.launches}
        for k, v in got.items():
            launches[k] += v
        log(f"phase 21 {name}: {time.perf_counter() - t0:.3f} s (first call, host clock); launches {got}")
        return out, got

    # Config 3: the sharded filters on the 4 x 2^20 streams.
    (y_ols, y_pf), got = counted("config 3 sharded_fir_ols(block=8192), sharded_partitioned_fir(block=1024)",
                                 lambda: (parallel.sharded_fir_ols(x3, h3, mesh, block=8192).to_local(),
                                          parallel.sharded_partitioned_fir(x3, h3, mesh, block=1024).to_local()))
    for name, y, atol in (("sharded_fir_ols", y_ols, 5e-4), ("sharded_partitioned_fir", y_pf, 1e-3)):
        require(tuple(y.shape) == tuple(x3.shape) and bool(torch.isfinite(y).all()), f"{name}: {tuple(y.shape)}")
        err = max_err(y, ref3)
        log(f"phase 21 config 3 {name}: max abs err vs float64 {err:.3e} (atol {atol})")
        require(err <= atol, f"phase 21 {name}: {err} > {atol}")
    for k in (hf.K1, hf.K3, hf.K2, convolve.PARTITIONED):
        require(got.get(k.name, 0) > 0, f"{k.name} was not launched on config 3's sharded path")

    # Config 4 at full width: both sharded forms against apply.
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=ir.shape[0], block=CONFIG4_BLOCK), device=dev)
    xa = torch.from_numpy(audio).to(dev)
    wet = conv.apply(xa)
    time_form = conv.time_sharded_apply(mesh, parallel.TIME_AXIS)
    chan_form = conv.channel_sharded_apply(cmesh)
    (yt, yc), got = counted("config 4 time_sharded_apply, channel_sharded_apply",
                            lambda: (time_form(xa).to_local(), chan_form(xa).to_local()))
    errs4 = {"time_sharded_apply": max_err(yt, wet), "channel_sharded_apply": max_err(yc, wet)}
    log("phase 21 config 4 (64 ch x 10 s, 2 s IRs, block 4096) vs apply: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs4.items()) + f" (atol {SHARDED_ATOL})")
    for key, v in errs4.items():
        require(v <= SHARDED_ATOL, f"phase 21 config 4 {key}: {v} > {SHARDED_ATOL}")
    for k in (hf.K1, hf.K2, convolve.PARTITIONED):
        require(got.get(k.name, 0) > 0, f"{k.name} was not launched on config 4's sharded paths")

    # Config 5: the sharded chain on the 2^24-sample capture.
    chain = models.SDRChain(models.SDRChainConfig(), device=dev)
    iq = torch.from_numpy(capture).to(dev)
    single = chain(iq)
    step = chain.sharded_step(mesh)
    sharded, got = counted("config 5 SDRChain.sharded_step", lambda: step(iq).to_local())
    require(tuple(sharded.shape) == tuple(single.shape), f"sharded audio {tuple(sharded.shape)}")
    # Noise-only channels' demod lands on either side of +-pi from one
    # rounding to the next (phase 7): held are the occupied channels after
    # the transient, every channel is reported.
    occ = list(CARRIERS)
    err5 = max_err(sharded[occ, AUDIO_SKIP:], single[occ, AUDIO_SKIP:])
    log(f"phase 21 config 5 sharded_step vs chain(capture): occupied channels {err5:.3e} (atol {SHARDED_ATOL}); "
        f"every channel {max_err(sharded, single):.3e}")
    require(err5 <= SHARDED_ATOL, f"phase 21 config 5: {err5} > {SHARDED_ATOL}")
    require(got.get(hs.K5_COMPLEX.name, 0) > 0, "K5 was not launched on config 5's sharded path")

    # The distributed FFT: config 2's top row, N = 2^24, the convolutions.
    n, rows = CONFIG2_TOP
    _, got = counted(f"distributed FFT N=2^{n.bit_length() - 1} B={rows}",
                     lambda: dist_fft_checks(parallel, mesh, dev, n, rows, 21))
    for k in (hf.K4, hf.K1, hf.K2):
        require(got.get(k.name, 0) > 0, f"{k.name} was not launched on the distributed FFT")
    counted(f"distributed FFT N=2^{DIST_BIG[0].bit_length() - 1} B={DIST_BIG[1]}",
            lambda: dist_fft_checks(parallel, mesh, dev, *DIST_BIG, 22))
    g = torch.Generator(device=dev).manual_seed(23)
    x, h, xi, hi = (torch.randn(DIST_CONV_ROWS, n, device=dev, generator=g) for _ in range(4))
    (yr, (cr, ci)), _ = counted(f"sharded_rfft_convolve, sharded_fft_convolve N=2^{n.bit_length() - 1} "
                                f"B={DIST_CONV_ROWS}",
                                lambda: (parallel.sharded_rfft_convolve(x, h, mesh).to_local(),
                                         tuple(t.to_local() for t in parallel.sharded_fft_convolve(x, xi, h, hi, mesh))))
    ref_r = torch.fft.irfft(torch.fft.rfft(x.double()) * torch.fft.rfft(h.double()), n=n)
    ref_c = torch.fft.ifft(torch.fft.fft(torch.complex(x.double(), xi.double()))
                           * torch.fft.fft(torch.complex(h.double(), hi.double())))
    err_r = max_err(yr, ref_r) / float(ref_r.abs().max())
    err_c = max_err(torch.complex(cr, ci), ref_c) / float(ref_c.abs().max())
    log(f"phase 21 circular convolutions vs float64, max err / peak: real {err_r:.3e} (bound "
        f"{DIST_REAL_CONV_RTOL}), complex {err_c:.3e} (bound {DIST_COMPLEX_CONV_RTOL})")
    require(err_r <= DIST_REAL_CONV_RTOL and err_c <= DIST_COMPLEX_CONV_RTOL, "phase 21 convolutions")
    del x, h, xi, hi, yr, cr, ci, ref_r, ref_c
    for k in (hf.K1, hf.K2, hf.K3, hf.K4, hs.K5_COMPLEX):
        require(launches[k.name] > 0, f"{k.name} was not launched on the parallel paths")

    phase21_timing(parallel, stream, roof, mesh, dev, card, conv, xa, chain, iq, x3, h3)
    return launches


def phase21_timing(parallel, stream, roof, mesh, dev, card, conv, xa, chain, iq, x3, h3) -> None:
    """Informational: the one-rank distributed FFT's device time (profiler)
    beside ct.fft and cuFFT at config 2's top row, the all_to_all's share
    (on one rank a copy), each sharded form's wall beside its unsharded
    call, and the halo model's prediction for config 4."""
    import chowdsp_fft_tpu_torch as ct

    n, rows = CONFIG2_TOP
    g = torch.Generator(device=dev).manual_seed(24)
    re, im = (torch.randn(rows, n, device=dev, generator=g) for _ in range(2))
    z = torch.complex(re, im)
    # The sharded call holds a collective, so no CUDA graph: its device time
    # is the profiler's (sum of device events, NCCL's own range apart,
    # which overlies the copy that carries it on one rank), the library
    # calls' the graph replay of the other phases.
    sharded = lambda: parallel.sharded_fft_planes(re, im, mesh)  # noqa: E731
    by_kernel = kernel_device_times(sharded)
    a2a = sum(v for k, v in by_kernel.items() if k.startswith("nccl:"))
    device = sum(v for k, v in by_kernel.items() if not k.startswith("nccl:"))
    for kname, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {v:9.4f} ms  {kname[:110]}")
    log(f"phase 21 timing sharded_fft_planes N=2^20 B={rows}: {time_ms(sharded, [()], iters=5, rounds=3):.4f} ms a "
        f"call (host-inclusive), device {device:.4f} ms (profiler), of it the one-rank all_to_all (NCCL) "
        f"{a2a:.4f} ms ({a2a / device:.3f}) [{card}]")
    for name, fn in (("ct.fft", lambda a: ct.fft(a)), ("torch.fft.fft", lambda a: torch.fft.fft(a))):
        ms, device_ms = both_ms(fn, [(z,)])
        log(f"phase 21 timing {name} N=2^20 B={rows}: {ms:.4f} ms a call (host-inclusive), device {device_ms:.4f} "
            f"ms (graph replay) [{card}]")
    del re, im, z
    forms = {
        "config 3 fir_filter_ols(block=8192)": (lambda: parallel.sharded_fir_ols(x3, h3, mesh, block=8192),
                                                lambda: stream.fir_filter_ols(x3, h3, block=8192)),
        "config 4 time_sharded_apply": (lambda: conv.time_sharded_apply(mesh, parallel.TIME_AXIS)(xa),
                                        lambda: conv.apply(xa)),
        "config 5 sharded_step": (lambda: chain.sharded_step(mesh)(iq), lambda: chain(iq)),
    }
    for name, (sharded, unsharded) in forms.items():
        log(f"phase 21 timing {name}: sharded wall {wall_ms(sharded, 3):.3f} ms, unsharded "
            f"{wall_ms(unsharded, 3):.3f} ms (median of 3, host clock) [{card}]")
    model = roof.halo_weak_scaling(xa.shape[-1], conv.taps, CONFIG4_BLOCK, overlap_comm=True)
    log(f"phase 21 model (not a measurement): halo_weak_scaling for config 4 (a card per time shard of "
        f"{xa.shape[-1]} samples, {conv.taps} taps, block {CONFIG4_BLOCK}; NVLink 4 data-sheet "
        f"{roof.H100_NVLINK_BYTES_PER_S / 1e9:.0f} GB/s a direction): compute bound "
        f"{model['t_compute_s'] * 1e3:.4f} ms, halo {model['t_halo_s'] * 1e3:.4f} ms, efficiency "
        f"{model['efficiency']:.3f} with the hop overlapped")


# ---------------------------------------------------------------------------
# Phase 22: the last modules on the card: the native planner, plan
# persistence, merge_precision, the numpy and JUCE adapters, profiling
# ---------------------------------------------------------------------------

PHASE22_DIR = pathlib.Path(__file__).resolve().parent / "build" / "phase22"  # gitignored
PLANNER_PLANS = ((4096, "real"), (256, "complex"), (256, "real"), (1 << 20, "real"), (1 << 20, "complex"))
JUCE_ORDERS = range(5, 21)
JUCE_ROWS = 8
JUCE_WIDE = (12, 1024)  # (order, rows)
OP_SECONDS_RATIO = (0.8, 1.25)  # op_seconds over phase 5's graph device time of the same K1 call


def check64(name: str, got: torch.Tensor, want: torch.Tensor, n: int) -> float:
    """Max abs error of ``got`` against the float64 ``want`` (both on the
    card), bound 2e-7*N; a zeroed output must fail the same bound."""
    bound = TOL * n
    err = max_err(got, want)
    require(err <= bound, f"{name}: {err:.3e} > {bound:.3e}")
    require(float(want.abs().max()) > bound, f"{name}: a zeroed output would pass ({bound:.3e})")
    return err


def counted(hf, fn):
    """(``fn()``, the launches it made): the counters are zeroed just before."""
    hf.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in hf.KERNELS if k.launches}


def ran(where: str, launches: dict[str, int], kernels, total: dict[str, int]) -> None:
    """Each of ``kernels`` was launched; add ``launches`` to ``total``."""
    for k in kernels:
        require(launches.get(k.name, 0) > 0, f"{where}: {k.name} was not launched ({launches})")
    for name, v in launches.items():
        total[name] = total.get(name, 0) + v


def names_kernel(text: str, kernel: str) -> bool:
    """Whether ``text`` names the CUDA kernel ``kernel`` (rfft_packed_kernel
    is not irfft_packed_kernel)."""
    return re.search(rf"\b{kernel}\b", text) is not None


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def phase22_planner(ct, native) -> None:
    """The planner is built from native/planner.cpp into build/native/, and
    the plans the engine reads hold its float64 tables cast to float32."""
    t0 = time.perf_counter()
    path = native.ensure_built()
    require(path is not None and native.available(), "the native planner did not build (g++)")
    require(path.parent == pathlib.Path(__file__).resolve().parent / "build" / "native", f"planner at {path}")
    for n, kind in PLANNER_PLANS:
        plan = ct.cached_plan(n, kind)
        tables = native.stage_twiddles(n // 2 if kind == "real" else n)
        require(len(tables) == len(plan.stages), f"{kind} {n}: {len(plan.stages)} stages, planner {len(tables)}")
        for st, (re, im) in zip(plan.stages, tables):
            require(np.array_equal(st.tw_re, re.astype(np.float32)) and np.array_equal(st.tw_im, im.astype(np.float32)),
                    f"{kind} {n}: a stage table differs from the planner's")
        if kind == "real":
            sre, sim = native.rfft_twiddles(n)
            require(np.array_equal(plan.rfft_tw_re, sre.astype(np.float32))
                    and np.array_equal(plan.rfft_tw_im, sim.astype(np.float32)), f"{kind} {n}: split table differs")
    log(f"phase 22 native planner {path.relative_to(pathlib.Path(__file__).resolve().parent)}: the tables of "
        f"{', '.join(f'{k} {n}' for n, k in PLANNER_PLANS)} bit-equal to its float64 tables cast to float32 "
        f"({time.perf_counter() - t0:.2f} s)")


def phase22_plans(ct, plans, hf, hs, hc, dev, total: dict[str, int]) -> None:
    """A plan saved and loaded drives K1 (ordered), K5 (complex and real),
    K7a and K7b with output torch.equal to a fresh plan's; a loaded plan
    with one split twiddle changed changes K1's output."""
    PHASE22_DIR.mkdir(parents=True, exist_ok=True)

    def loaded(n: int, kind: str):
        path = PHASE22_DIR / f"plan_{kind}_{n}"
        plans.save_plan(ct.make_plan(n, kind), path)
        plan = plans.load_plan(path)
        require(not plan._on_device, "a loaded plan made device tables before its first use")
        return plan

    g = torch.Generator(device=dev).manual_seed(2201)
    n, rows = HEADLINE
    ns, rs = SMALL_TIMED
    nl_, rl = CONFIG2_TOP
    x = torch.randn(rows, n, device=dev, generator=g)
    xs = torch.randn(rs, ns, device=dev, generator=g)
    zs = torch.complex(torch.randn(rs, ns, device=dev, generator=g), torch.randn(rs, ns, device=dev, generator=g))
    xl = torch.randn(rl, nl_, device=dev, generator=g)
    sl = ct.rfft_packed(xl)
    routes = (
        (f"K1 ordered {n} x {rows}", n, "real", lambda p: ct.rfft_packed(x, plan=p), (hf.K1,)),
        (f"K5 complex {ns} x {rs}", ns, "complex", lambda p: ct.fft(zs, plan=p), (hs.K5_COMPLEX,)),
        (f"K5 real {ns} x {rs}", ns, "real", lambda p: ct.rfft_packed(xs, plan=p), (hs.K5_REAL,)),
        (f"K7a {nl_} x {rl}", nl_, "real", lambda p: ct.rfft_packed(xl, plan=p), (hc.K7A,)),
        (f"K7b {nl_} x {rl}", nl_, "real", lambda p: ct.irfft_packed(*sl, plan=p), (hc.K7B,)),
    )
    for name, size, kind, fn, kernels in routes:
        want = as_tuple(fn(ct.make_plan(size, kind)))
        got, launches = counted(hf, lambda: fn(loaded(size, kind)))
        ran(f"phase 22 loaded plan, {name}", launches, kernels, total)
        require(all(torch.equal(a, b) for a, b in zip(as_tuple(got), want)), f"{name}: a loaded plan's output differs")
    tampered = loaded(n, "real")
    tampered.rfft_tw_re[5] = -tampered.rfft_tw_re[5]
    want = ct.rfft_packed(x, plan=ct.make_plan(n, "real"))
    got = ct.rfft_packed(x, plan=tampered)
    require(not all(torch.equal(a, b) for a, b in zip(got, want)), "K1 ignored a changed split twiddle of its plan")
    log(f"phase 22 save_plan/load_plan: {', '.join(r[0] for r in routes)} torch.equal to a fresh plan's; one split "
        f"twiddle changed moves K1's output by {max(max_err(a, b) for a, b in zip(got, want)):.3e}")


def phase22_merge(ct, hf, hs, dev, total: dict[str, int]) -> None:
    """Under merge_precision("bf16x3") K1, K2, K3 (config 3's shape, a
    shared filter), K4 and K5 give output torch.equal to "highest"'s, and
    the caller's precision comes back."""
    prev = torch.get_float32_matmul_precision()
    g = torch.Generator(device=dev).manual_seed(2202)
    n, rows = HEADLINE
    n3, r3 = GRAD_CONV
    ns, rs = SMALL_TIMED
    x = torch.randn(rows, n, device=dev, generator=g)
    z = torch.complex(torch.randn(rows, n, device=dev, generator=g), torch.randn(rows, n, device=dev, generator=g))
    re, im = ct.rfft_packed_unordered(x)
    a3 = [torch.randn(r3, n3 // 2, device=dev, generator=g) for _ in range(2)]
    b3 = [torch.randn(1, n3 // 2, device=dev, generator=g) for _ in range(2)]
    zs = torch.complex(torch.randn(rs, ns, device=dev, generator=g), torch.randn(rs, ns, device=dev, generator=g))
    calls = (
        (hf.K1, lambda: ct.rfft_packed_unordered(x)),
        (hf.K2, lambda: ct.irfft_packed_unordered(re, im)),
        (hf.K3, lambda: ct.convolve_irfft_packed(*a3, *b3, scaling=1.0 / n3, ordered=False)),
        (hf.K4, lambda: ct.fft(z)),
        (hs.K5_COMPLEX, lambda: ct.fft(zs)),
    )
    for k, fn in calls:
        with ct.merge_precision("highest"):
            want = as_tuple(fn())
        with ct.merge_precision("bf16x3"):
            require(hf._merge_mode() == "bf16x3" and torch.get_float32_matmul_precision() == "high", "bf16x3 carrier")
            got, launches = counted(hf, fn)
        require(torch.get_float32_matmul_precision() == prev, "merge_precision did not restore the precision")
        ran(f"phase 22 merge_precision {k.name}", launches, (k,), total)
        require(all(torch.equal(a, b) for a, b in zip(as_tuple(got), want)), f"{k.name}: bf16x3 output differs")
    log(f"phase 22 merge_precision: bf16x3 output torch.equal to highest for {', '.join(k.name for k, _ in calls)}; "
        f"the float32 matmul precision restored to {prev!r}")


def phase22_numpy(ct, nl, hf, hc, dev, total: dict[str, int]) -> None:
    """The numpy adapter at the headline and config 2's top row, one axis=0
    and one n= case and a host array, against float64 on the card
    (inverses rescaled by N)."""
    worst = 0.0
    for n, rows in (HEADLINE, CONFIG2_TOP):
        g = torch.Generator(device=dev).manual_seed(n + rows)
        x = torch.randn(rows, n, device=dev, generator=g)
        z = torch.complex(torch.randn(rows, n, device=dev, generator=g), torch.randn(rows, n, device=dev, generator=g))
        # The inverses take spectra of unit-scale data, so their scaled
        # outputs are unit-scale too: a zeroed output fails the bound.
        zs = torch.fft.fft(z.to(torch.complex128)).to(torch.complex64)
        s = torch.fft.rfft(x.double()).to(torch.complex64)
        big = n > hf.MAX_N
        cases = (
            ("fft", lambda: nl.fft(z), lambda: torch.fft.fft(z.to(torch.complex128)),
             (hc.K6_L1, hc.K6_L2) if big else (hf.K4,)),
            ("ifft", lambda: nl.ifft(zs), lambda: torch.fft.ifft(zs.to(torch.complex128)),
             (hc.K6_L2_REV, hc.K6_L1_REV) if big else (hf.K4,)),
            ("rfft", lambda: nl.rfft(x), lambda: torch.fft.rfft(x.double()), (hc.K7A,) if big else (hf.K1,)),
            ("irfft", lambda: nl.irfft(s), lambda: torch.fft.irfft(s.to(torch.complex128), n=n),
             (hc.K7B,) if big else (hf.K2,)),
        )
        for name, fn, ref, kernels in cases:
            got, launches = counted(hf, fn)
            ran(f"phase 22 numpy_like.{name} {n} x {rows}", launches, kernels, total)
            require(got.device == dev, f"numpy_like.{name}: output on {got.device}")
            worst = max(worst, check64(f"numpy_like.{name} {n} x {rows}", got, ref(), n) / (TOL * n))
        del x, z, zs, s
    g = torch.Generator(device=dev).manual_seed(2203)
    xa = torch.randn(4096, 64, device=dev, generator=g)
    got, launches = counted(hf, lambda: nl.rfft(xa, axis=0))
    ran("phase 22 numpy_like.rfft axis=0", launches, (hf.K1,), total)
    worst = max(worst, check64("numpy_like.rfft axis=0", got, torch.fft.rfft(xa.double(), dim=0), 4096) / (TOL * 4096))
    zp = torch.complex(torch.randn(64, 3000, device=dev, generator=g), torch.randn(64, 3000, device=dev, generator=g))
    got, launches = counted(hf, lambda: nl.fft(zp, n=4096))
    ran("phase 22 numpy_like.fft n=4096", launches, (hf.K4,), total)
    worst = max(worst, check64("numpy_like.fft n=4096 (3000 padded)", got,
                               torch.fft.fft(zp.to(torch.complex128), n=4096), 4096) / (TOL * 4096))
    host = xa.T.contiguous().cpu().numpy()
    got, launches = counted(hf, lambda: nl.rfft(host))
    ran("phase 22 numpy_like.rfft of a host array", launches, (hf.K1,), total)
    require(got.device.type == "cuda", f"a host array's transform landed on {got.device}")
    check64("numpy_like.rfft of a host array", got, torch.fft.rfft(xa.T.double()), 4096)
    log(f"phase 22 numpy adapter: fft/ifft/rfft/irfft at {HEADLINE[0]} x {HEADLINE[1]} and {CONFIG2_TOP[0]} x "
        f"{CONFIG2_TOP[1]}, rfft axis=0, fft n=4096 of 3000, a host array: worst {worst:.3e} of 2e-7*N")


def phase22_juce(JuceStyleFFT, hf, hs, hc, dev, total: dict[str, int]) -> None:
    """JuceStyleFFT at every order 5..20 on 8 rows and order 12 on 1024
    rows: perform both ways, the real-only transforms both ways and the
    frequency-only transform, against float64 on the card, each on the
    kernels its size dispatches to."""

    def kernels(order: int, what: str):
        if what in ("fwd", "inv"):
            if order <= 8:
                return (hs.K5_COMPLEX,)
            if order <= 13:
                return (hf.K4,)
            return (hc.K6_L1, hc.K6_L2) if what == "fwd" else (hc.K6_L2_REV, hc.K6_L1_REV)
        if order <= 8:
            return (hs.K5_REAL_INVERSE,) if what == "real_inv" else (hs.K5_REAL,)
        if order <= 14:
            return (hf.K2,) if what == "real_inv" else (hf.K1,)
        return (hc.K7B, hc.K6_L2_REV) if what == "real_inv" else (hc.K7A, hc.K6_L2)

    worst = 0.0
    g = torch.Generator(device=dev).manual_seed(2204)
    for order, rows in [(o, JUCE_ROWS) for o in JUCE_ORDERS] + [JUCE_WIDE]:
        n = 1 << order
        f = JuceStyleFFT(order)
        x = torch.randn(rows, n, device=dev, generator=g)
        z = torch.complex(torch.randn(rows, n, device=dev, generator=g), torch.randn(rows, n, device=dev, generator=g))
        z64 = z.to(torch.complex128)
        spec = torch.fft.fft(z64).to(torch.complex64)  # spectra of unit-scale data for the inverses
        buf64 = torch.view_as_real(torch.fft.rfft(x.double())).reshape(rows, n + 2)
        buf = buf64.float()
        mags64 = torch.nn.functional.pad(torch.fft.rfft(x.double()).abs(), (0, n - n // 2 - 1))
        cases = (
            ("perform", "fwd", lambda: f.perform(z), lambda: torch.fft.fft(z64)),
            ("perform inverse", "inv", lambda: f.perform(spec, inverse=True),
             lambda: torch.fft.ifft(spec.to(torch.complex128))),
            ("real-only forward", "real_fwd", lambda: f.perform_real_only_forward_transform(x), lambda: buf64),
            ("real-only inverse", "real_inv", lambda: f.perform_real_only_inverse_transform(buf),
             lambda: torch.fft.irfft(torch.view_as_complex(buf.double().reshape(rows, -1, 2)), n=n)),
            ("frequency-only", "real_fwd", lambda: f.perform_frequency_only_forward_transform(x), lambda: mags64),
        )
        for name, what, fn, ref in cases:
            got, launches = counted(hf, fn)
            ran(f"phase 22 JuceStyleFFT({order}).{name} on {rows} rows", launches, kernels(order, what), total)
            worst = max(worst, check64(f"JuceStyleFFT({order}).{name}", got, ref(), n) / (TOL * n))
        require(bool((f.perform_frequency_only_forward_transform(x)[:, n // 2 + 1 :] == 0).all()), "magnitudes' pad")
    log(f"phase 22 JUCE adapter: orders {JUCE_ORDERS.start}-{JUCE_ORDERS.stop - 1} on {JUCE_ROWS} rows and order "
        f"{JUCE_WIDE[0]} on {JUCE_WIDE[1]}, five transforms each: worst {worst:.3e} of 2e-7*N; K5 to order 8, K4 "
        f"(complex) 9-13 and K6 14-20, K1/K2 (real) 9-14 and K7a/K7b with K6 level 2 15-20")


def phase22_profiling(ct, profiling, hf, stream, models, dev, card, k1_device_ms: float, audio, ir) -> None:
    """profiling.op_seconds of rfft_packed_unordered at the headline against
    phase 5's graph device time of the same K1 call; graph-replay device
    totals (op_seconds) of the paths whose profiler totals dropped K1 or
    K2, beside the profiler's; last, trace writes a file naming K1's
    kernel in a fresh process (and, informational, in this one)."""
    n, rows = HEADLINE
    g = torch.Generator(device=dev).manual_seed(2205)
    xs = tuple(torch.randn(rows, n, device=dev, generator=g) for _ in range(4))  # 64 MB: beyond the 50 MB L2

    def body(c):
        inputs, _ = c
        return inputs[1:] + inputs[:1], ct.rfft_packed_unordered(inputs[0])

    ms = profiling.op_seconds(body, (xs, ct.rfft_packed_unordered(xs[0]))) * 1e3
    ratio = ms / k1_device_ms
    log(f"phase 22 profiling.op_seconds(rfft_packed_unordered, N={n} B={rows}): {ms:.4f} ms; phase 5's graph device "
        f"time of K1 {k1_device_ms:.4f} ms; ratio {ratio:.3f} (allowed {OP_SECONDS_RATIO}) [{card}]")
    require(OP_SECONDS_RATIO[0] <= ratio <= OP_SECONDS_RATIO[1], f"op_seconds / graph time {ratio:.3f}")

    # Device totals by graph replay beside the profiler's (PERF.md section 7).
    channels, t = audio.shape
    xa = torch.from_numpy(audio).to(dev)
    n_fft, hop = STFT
    window = torch.from_numpy(stream.hann_window(n_fft)).to(dev)
    spec = stream.stft(xa, n_fft=n_fft, hop=hop)
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=channels, block=CONFIG4_BLOCK), device=dev)
    state, frame = conv.init_state(), xa[:, :CONFIG4_BLOCK]

    def power(_):
        # spectrogram's device work, with its window already on the card (spectrogram uploads it each call: a copy
        # from host memory, which a graph cannot capture)
        s = stream.stft(xa, n_fft=n_fft, hop=hop, window=window)
        return s.real ** 2 + s.imag ** 2

    require(torch.equal(power(None), stream.spectrogram(xa, n_fft=n_fft, hop=hop)), "the captured spectrogram differs")
    paths = (
        # (name, the call the profiler reads, the captured body and its carry, what the body is)
        ("spectrogram", lambda: stream.spectrogram(xa, n_fft=n_fft, hop=hop), power, xa, "the same work"),
        ("istft", lambda: stream.istft(spec, hop=hop, length=t), lambda _: ct.irfft(spec), spec,
         "its irfft only: istft uploads its window and COLA table from the host each call"),
        ("istft's irfft", lambda: ct.irfft(spec), lambda _: ct.irfft(spec), spec, "the same work"),
        (f"config 4 step ({channels} x {CONFIG4_BLOCK})", lambda: conv.step(state, frame),
         lambda s: conv.step(s, frame)[0], state, "the same work"),
    )
    for name, call, captured, init, what in paths:
        by_kernel = kernel_device_times(call)
        k1 = sum(v for k, v in by_kernel.items() if names_kernel(k, hf.K1.name))
        k2 = sum(v for k, v in by_kernel.items() if names_kernel(k, hf.K2.name))
        try:
            graph = f"{profiling.op_seconds(captured, init) * 1e3:.4f} ms ({what})"
        except RuntimeError as e:  # a path that syncs with the host cannot be captured
            graph = f"not captured ({str(e).splitlines()[0][:120]})"
        log(f"phase 22 device total {name}: graph replay {graph}; profiler {sum(by_kernel.values()):.4f} ms (K1 "
            f"{k1:.4f}, K2 {k2:.4f}) [{card}]")

    # profiling.trace in a fresh process, where it must name K1's kernel, then in this one (informational: in a
    # process that has run for minutes its Chrome trace has come out without kernel events).
    out = subprocess.run([sys.executable, "-c", TRACE_CHECK, str(pathlib.Path(__file__).resolve().parent),
                          str(PHASE22_DIR / "trace"), str(n), str(rows)],
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f"the trace process failed: {out.stderr[-2000:]}")
    fresh = trace_kernels(pathlib.Path(out.stdout.strip().splitlines()[-1]), hf.K1.name)
    require(fresh[0] > 0, f"a fresh process's trace names no {hf.K1.name}: {fresh}")
    with profiling.trace(PHASE22_DIR / "trace") as log_dir:
        ct.rfft_packed_unordered(xs[0])
    here = trace_kernels(max(pathlib.Path(log_dir).glob("trace_*.json"), key=lambda p: p.stat().st_mtime_ns),
                         hf.K1.name)
    in_events = sum(1 for k in kernel_device_times(lambda: ct.rfft_packed_unordered(xs[0])) if names_kernel(k, hf.K1.name))
    log(f"phase 22 profiling.trace: a fresh process's Chrome trace has {fresh[0]} {hf.K1.name} event(s) of "
        f"{fresh[1]} kernel events; this process's (at {time.perf_counter() - _START:.0f} s) {here[0]} of {here[1]}, "
        f"and the profiler's parsed events of the same call name it {in_events} time(s)")
    del xs


TRACE_CHECK = """
import pathlib, sys
sys.path.insert(0, sys.argv[1])
import torch
import chowdsp_fft_tpu_torch as ct
from chowdsp_fft_tpu_torch.utils import profiling
x = torch.randn(int(sys.argv[4]), int(sys.argv[3]), device="cuda")
ct.rfft_packed_unordered(x)
with profiling.trace(sys.argv[2]) as log_dir:
    ct.rfft_packed_unordered(x)
print(max(pathlib.Path(log_dir).glob("trace_*.json"), key=lambda p: p.stat().st_mtime_ns))
"""


def trace_kernels(path: pathlib.Path, kernel: str) -> tuple[int, int]:
    """(events naming ``kernel``, all kernel events) of a Chrome trace."""
    kernels = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "kernel"]
    return sum(names_kernel(e["name"], kernel) for e in kernels), len(kernels)


def phase22(ct, hf, hs, hc, stream, models, dev, card, k1_device_ms: float, audio, ir) -> dict[str, int]:
    """The last modules on the card, through the kernels. Returns the
    launches of the phase's paths (before its timing)."""
    from chowdsp_fft_tpu_torch import plans
    from chowdsp_fft_tpu_torch.adapters import JuceStyleFFT
    from chowdsp_fft_tpu_torch.adapters import numpy_like
    from chowdsp_fft_tpu_torch.utils import native, profiling

    t_phase = time.perf_counter()
    total: dict[str, int] = {}
    phase22_planner(ct, native)
    phase22_plans(ct, plans, hf, hs, hc, dev, total)
    phase22_merge(ct, hf, hs, dev, total)
    phase22_numpy(ct, numpy_like, hf, hc, dev, total)
    phase22_juce(JuceStyleFFT, hf, hs, hc, dev, total)
    log(f"phase 22 paths ok in {time.perf_counter() - t_phase:.1f} s; launches {total}")
    phase22_profiling(ct, profiling, hf, stream, models, dev, card, k1_device_ms, audio, ir)
    log(f"phase 22 ok in {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# Phase 23: the offline FDL's kernel against its plain version
# ---------------------------------------------------------------------------

# (streams, blocks, slots, partitions, shared filter, what): the reverb's
# FDL, config 3's at block 1024, one long stream the wrapper splits into
# runs, and more partitions than a thread holds in registers (3 passes).
FDL_SHAPES = (
    (64, 118, 4096, 24, False, "the reverb (config 4)"),
    (4, 1024, 1024, 4, True, "config 3 at block 1024"),
    (1, 938, 1024, 24, False, "one stream in runs"),
    (8, 118, 4096, 80, True, "80 partitions, shared"),
)
FDL_GAP = 1e-5  # max |kernel - plain| over the plain output's rms: float32 sums of up to 32 products in another order


def fdl_gap(got, want) -> float:
    """max |got - want| over rms(want), both planes."""
    g, w = torch.stack([t.double() for t in got]), torch.stack([t.double() for t in want])
    return float((g - w).abs().max() / w.pow(2).mean().sqrt())


def fdl_bound(roof, streams: int, nb: int, m: int, partitions: int, shared: bool):
    """The partitioned accumulate's bound: X and H read once, Y written
    once (two float32 planes each); 8 operations a slot for each
    block-partition product."""
    planes = 2 * 4 * streams * nb * m
    filt = 2 * 4 * (1 if shared else streams) * partitions * m
    products = streams * sum(min(partitions, b + 1) for b in range(nb))
    return roof.roofline(2 * planes + filt, 8 * products * m)


def phase23(_cuda, convolve, roof, lib_path, dev, card) -> tuple[float, dict, object]:
    """``convolve_accumulate_partitioned`` (one launch of
    ``csrc/partitioned_accumulate.cu``) against its plain version on the
    same card tensors at every shape of FDL_SHAPES, within FDL_GAP; a
    zeroed output and a filter with its last partition dropped must fail
    the check. Then (informational) ptxas's registers of each sub-ring
    count and the device time at each shape against its bound. Returns
    the worst max abs error, the times at the reverb's shape and their
    bound."""
    k = convolve.PARTITIONED
    for line in _cuda.kernel_resources(lib_path, k.name):
        log(f"phase 23 ptxas {k.name}: {line}")
    g = torch.Generator(device=dev)
    g.manual_seed(20261018)

    def inputs(streams, nb, m, partitions, shared):
        x = tuple(torch.randn(streams, nb, m, device=dev, generator=g) for _ in range(2))
        h = tuple(torch.randn(1 if shared else streams, partitions, m, device=dev, generator=g) / partitions
                  for _ in range(2))
        return x, h

    worst = 0.0
    for i, (streams, nb, m, partitions, shared, what) in enumerate(FDL_SHAPES):
        x, h = inputs(streams, nb, m, partitions, shared)
        scale = 1.0 / (2 * m)
        before = k.launches
        got = convolve.convolve_accumulate_partitioned(x, h, scale)
        torch.cuda.synchronize()
        require(k.launches == before + 1, f"{k.name}: {k.launches - before} launches for one call")
        want = convolve.convolve_accumulate_partitioned_plain(x, h, scale)
        gap = fdl_gap(got, want)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        worst = max(worst, err)
        groups, run = convolve.partitioned_geometry(streams, nb, m, partitions)
        log(f"phase 23 {what} ({streams} x {nb} x {m}, P={partitions}, {'shared' if shared else 'per-stream'} "
            f"filter; {groups} sub-rings, runs of {run} blocks): max |kernel - plain| {err:.3e}, "
            f"{gap:.3e} of rms (limit {FDL_GAP})")
        require(gap <= FDL_GAP, f"{k.name} at {what}: {gap:.3e} of rms > {FDL_GAP}")
        if i == 0:
            zeroed = fdl_gap(tuple(torch.zeros_like(t) for t in got), want)
            dropped = tuple(t.clone() for t in h)
            for t in dropped:
                t[:, -1] = 0
            short = fdl_gap(convolve.convolve_accumulate_partitioned(x, dropped, scale), want)
            log(f"phase 23 planted faults: zeroed output {zeroed:.3e}, last partition dropped {short:.3e} of rms")
            require(zeroed > FDL_GAP and short > FDL_GAP, "a planted fault passed the check")
        del x, h, got, want

    times = None
    for i, (streams, nb, m, partitions, shared, what) in enumerate(FDL_SHAPES):
        xs = [inputs(streams, nb, m, partitions, shared) for _ in range(2)]
        h = xs[0][1]
        args = [x for x, _ in xs]
        scale = 1.0 / (2 * m)
        bound = fdl_bound(roof, streams, nb, m, partitions, shared)

        def kernel(xr, xi):
            return convolve.convolve_accumulate_partitioned((xr, xi), h, scale)

        def plain(xr, xi):
            return convolve.convolve_accumulate_partitioned_plain((xr, xi), h, scale)

        t = kernel_times(kernel, plain, args)
        log(f"phase 23 {k.name} {what} ({streams} x {nb} x {m}, P={partitions}): kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, bound {bound.ms:.4f} ms ({bound.bound_by}; "
            f"{100 * bound.ms / t['device_ms']:.1f}% of it) [{card}]")
        if i == 0:
            times, reverb_bound = t, bound
        del xs, h, args
    torch.cuda.empty_cache()
    log("phase 23 ok")
    return worst, times, reverb_bound


# ---------------------------------------------------------------------------
# Phase 24: the polyphase decimator against its plain version
# ---------------------------------------------------------------------------

# (rows, T, factor, taps, layout, what): config 5's two decimators on
# contiguous rows and as the chain lays them out (the front end's I/Q
# interleaved in the capture, the audio filter's input channel-fastest),
# odd rows that start off 16-byte boundaries, and the domain's corner.
DECIM_SHAPES = (
    (2, 1 << 24, 2, 64, "rows", "config 5's front end, I and Q planes"),
    (2, 1 << 24, 2, 64, "interleaved", "config 5's front end, the interleaved capture"),
    (256, 32768, 4, 64, "rows", "config 5's audio filter, contiguous rows"),
    (256, 32768, 4, 64, "channels", "config 5's audio filter, channel-fastest"),
    (3, 100003, 3, 21, "offset", "odd rows off 16-byte boundaries"),
    (2, 50000, 16, 1024, "rows", "the domain's corner"),
)
DECIM_GAP = 1e-5  # max |kernel - plain| over the plain output's rms: float32 sums of the same taps in another order


def decim_rows(rows: int, t: int, layout: str, dev, g) -> torch.Tensor:
    """(rows, T) float32 rows laid out as ``layout`` says: contiguous, one
    float past a 16-byte boundary (with an odd T each row starts
    elsewhere), the two planes of an interleaved complex64 capture, or
    channel-fastest (a (T, rows) tensor, transposed)."""
    if layout == "rows":
        return torch.randn(rows, t, device=dev, generator=g)
    if layout == "offset":
        return torch.randn(rows * t + 1, device=dev, generator=g)[1:].view(rows, t)
    if layout == "interleaved":
        return torch.view_as_real(torch.randn(t, dtype=torch.complex64, device=dev, generator=g)).T
    return torch.randn(t, rows, device=dev, generator=g).T


def decim_bound(roof, rows: int, t: int, factor: int, taps: int):
    """The decimator's bound: x and the taps read once, y written once;
    one FMA (2 operations) a tap for each kept output."""
    m = t // factor
    return roof.roofline(4 * (rows * t + rows * m + taps), 2 * rows * m * taps)


def phase24(_cuda, polyphase, roof, lib, lib_path, dev, card) -> tuple[float, dict, object]:
    """``polyphase.decimate_kernel`` (one launch of ``csrc/polyphase.cu``)
    against ``decimate_plain`` on the same card tensors at every shape
    and layout of DECIM_SHAPES, within DECIM_GAP; a zeroed output and a
    filter without its last tap must fail the check. Then
    (informational) ptxas's registers and, at the chain's shapes, the
    kernel's time beside its plain version's, cuDNN's ``conv1d`` on the
    unframed rows and the bound. Returns the worst max abs error, the
    times at the front end's shape as the chain reads it and their
    bound."""
    import torch.nn.functional as F

    k = polyphase.DECIMATE
    limits = (lib.hopper_decimate_max_taps(), lib.hopper_decimate_max_factor())
    require(limits == (_cuda.MAX_DECIM_TAPS, _cuda.MAX_DECIM_FACTOR),
            f"decimator limits {limits} differ from Python's")
    for line in _cuda.kernel_resources(lib_path, k.name):
        log(f"phase 24 ptxas {k.name}: {line}")
    g = torch.Generator(device=dev)
    g.manual_seed(20261019)

    def taps_of(n):
        return torch.randn(n, device=dev, generator=g) / n**0.5

    worst = 0.0
    for i, (rows, t, factor, taps, layout, what) in enumerate(DECIM_SHAPES):
        x, h = decim_rows(rows, t, layout, dev, g), taps_of(taps)
        before = k.launches
        got = polyphase.decimate_kernel(x, h, factor)
        torch.cuda.synchronize()
        require(k.launches == before + 1, f"{k.name}: {k.launches - before} launches for one call")
        want = polyphase.decimate_plain(x, h, factor)
        gap = fdl_gap((got,), (want,))
        err = float((got - want).abs().max())
        worst = max(worst, err)
        threads, rb, q, smem = polyphase.decimate_geometry(factor, taps, x.stride(-1) == 1, rows)
        log(f"phase 24 {what} ({rows} x {t}, strides {tuple(x.stride())}, f={factor}, {taps} taps; {threads} "
            f"threads, {rb} rows a block, {q} taps a phase, {smem} B): max |kernel - plain| {err:.3e}, {gap:.3e} "
            f"of rms (limit {DECIM_GAP})")
        require(gap <= DECIM_GAP, f"{k.name} at {what}: {gap:.3e} of rms > {DECIM_GAP}")
        if i == 0:
            zeroed = fdl_gap((torch.zeros_like(got),), (want,))
            short = h.clone()
            short[-1] = 0
            dropped = fdl_gap((polyphase.decimate_kernel(x, short, factor),), (want,))
            log(f"phase 24 planted faults: zeroed output {zeroed:.3e}, last tap dropped {dropped:.3e} of rms")
            require(zeroed > DECIM_GAP and dropped > DECIM_GAP, "a planted fault passed the check")
        del x, h, got, want

    times = front_bound = None
    for rows, t, factor, taps, layout, what in DECIM_SHAPES[:4]:
        args = [(decim_rows(rows, t, layout, dev, g),) for _ in range(2)]
        h = taps_of(taps)
        flipped = torch.flip(h, (-1,))[None, None, :]
        bound = decim_bound(roof, rows, t, factor, taps)

        def cudnn(x):
            with polyphase.fp32_convolutions():
                return F.conv1d(F.pad(x, (taps - 1, 0))[:, None, :], flipped, stride=factor)[:, 0, : t // factor]

        tm = kernel_times(lambda x: polyphase.decimate_kernel(x, h, factor),
                          lambda x: polyphase.decimate_plain(x, h, factor), args, cudnn)
        log(f"phase 24 {k.name} {what} ({rows} x {t}, f={factor}, {taps} taps): kernel {tm['ms']:.4f} ms (device "
            f"{tm['device_ms']:.4f} ms), plain {tm['plain_ms']:.4f} ms, library (cuDNN conv1d, unframed) "
            f"{tm['library_ms']:.4f} ms (device {tm['library_device_ms']:.4f} ms), bound {bound.ms:.4f} ms "
            f"({bound.bound_by}; {100 * bound.ms / tm['device_ms']:.1f}% of it, a gap of "
            f"{tm['device_ms'] / bound.ms:.2f}x) [{card}]")
        if layout == "interleaved":
            times, front_bound = tm, bound
        del args, h
    torch.cuda.empty_cache()
    log("phase 24 ok")
    return worst, times, front_bound

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    import chowdsp_fft_tpu_torch as ct
    from chowdsp_fft_tpu_torch import models, stream
    from chowdsp_fft_tpu_torch.ops import _cuda, autodiff, convolve, hopper_cfft, hopper_small, polyphase, row_passes
    from chowdsp_fft_tpu_torch.ops import tables
    from chowdsp_fft_tpu_torch.ops import hopper_composite as hc
    from chowdsp_fft_tpu_torch.ops import hopper_fft as hf
    from chowdsp_fft_tpu_torch.utils import roofline as roof

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    torch.manual_seed(20261016)

    # -- phase 1 ------------------------------------------------------------
    card = card_line()
    print(card, flush=True)  # the nvidia-smi line as it is: name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    lib = _cuda.library()
    limits = (lib.hopper_real_fft_max_n(), lib.hopper_complex_fft_max_n(), lib.hopper_small_fft_max_n(),
              lib.hopper_composite_max_col(), lib.hopper_small_fft_points_per_thread(),
              lib.hopper_row_points_per_thread())
    require(limits == (hf.MAX_N, hopper_cfft.MAX_CN, hopper_small.MAX_SMALL_N, hc.MAX_COL,
                       hopper_small.POINTS_PER_THREAD, row_passes.POINTS_PER_THREAD),
            f"kernel limits (MAX_N, MAX_CN, MAX_SMALL_N, MAX_COL, K5 POINTS_PER_THREAD, K1/K4 POINTS_PER_THREAD) "
            f"{limits} differ from Python's")
    # ptxas's registers and spills of the row engine's kernels (K1-K4 and
    # their pipelined forms) and the column engine's (K6's four roles, K7a,
    # K7b), as the build recorded them.
    for mangled in ("18rfft_packed_kernel", "19irfft_packed_kernel", "11cfft_kernel", "14rfft_db_kernel",
                    "15irfft_db_kernel", "14cfft_db_kernel", "20column_passes_kernel", "22rfft_col_passes_kernel",
                    "23irfft_col_passes_kernel"):
        lines = _cuda.kernel_resources(lib_path, mangled)
        require(bool(lines), f"no ptxas report of {mangled[2:]}")
        for line in lines:
            log(f"phase 1 ptxas {mangled[2:]}: {line}")
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
    k1_worst, _ = k1_domain(ct, hf, tables, dev, rng)
    k23_worst, _ = k2_k3_domain(ct, hf, tables, dev, rng)
    log("phase 2 ok")

    # -- phase 3 ------------------------------------------------------------
    s, t, taps = CONFIG3["streams"], CONFIG3["samples"], CONFIG3["taps"]
    x64 = rng.standard_normal((s, t))
    h64 = rng.standard_normal(taps) / np.sqrt(taps)
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    h = torch.from_numpy(h64.astype(np.float32)).to(dev)
    hf.reset_launch_counts()
    convolve.PARTITIONED.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_ols = stream.fir_filter_ols(x, h, block=8192)
    y_pfir = stream.partitioned_fir_apply(x, h, block=1024)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS + convolve.KERNELS}
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
    for k in (hf.K1, hf.K2, hf.K3, convolve.PARTITIONED):
        require(launches[k.name] > 0, f"{k.name} was not launched on the main path")
    for n in (2048, 4096, 16384):
        require(ct.engine_for(n, "real") == "hopper", f"engine_for({n}) = {ct.engine_for(n, 'real')}")
    log("phase 4 ok: every kernel carried the path")

    # -- phase 5 ------------------------------------------------------------
    n, rows = HEADLINE
    plan = ct.cached_plan(n, ct.FFT_REAL)
    xs = [(torch.randn(rows, n, device=dev),) for _ in range(4)]
    specs = [hf.rfft_packed_kernel(xi, plan, False) for (xi,) in xs]
    cspecs = [(torch.fft.rfft(xi),) for (xi,) in xs]
    filt = specs[0][0][:1].clone(), specs[0][1][:1].clone()
    times = {
        hf.K1.name: kernel_times(lambda a: hf.rfft_packed_kernel(a, plan, False),
                                 lambda a: hf.rfft_packed_plain(a, plan, False), xs, lambda a: torch.fft.rfft(a)),
        hf.K2.name: kernel_times(lambda r, i: hf.irfft_packed_kernel(r, i, plan, False),
                                 lambda r, i: hf.irfft_packed_plain(r, i, plan, False), specs,
                                 lambda c: torch.fft.irfft(c, n=n, norm="forward"), cspecs),
        hf.K3.name: kernel_times(lambda r, i: hf.convolve_irfft_packed_kernel(r, i, *filt, 1.0 / n, plan, False),
                                 lambda r, i: hf.convolve_irfft_packed_plain(r, i, *filt, 1.0 / n, plan, False),
                                 specs),
    }
    del xs, specs, cspecs
    for name, t in times.items():
        log_times(5, name, f"N={n} B={rows} unordered", t, card)
    g = row_passes.launch_geometry(plan, rows)
    for which, k in enumerate((hf.K1, hf.K2, hf.K3), start=1):
        log(f"phase 5 {k.name} geometry: {g.passes}, {g.rows_per_block} rows and {g.threads} threads a block, "
            f"{g.smem_bytes} B; {lib.hopper_real_fft_blocks_per_sm(which, g.threads, g.smem_bytes)} resident "
            f"blocks per SM")

    errs = {k.name: max(v for key, v in headline_err.items()
                        if key.startswith(prefix) and key.endswith("twin"))
            for k, prefix in ((hf.K1, "k1"), (hf.K2, "k2"), (hf.K3, "k3"))}
    errs[hf.K1.name] = max(errs[hf.K1.name], k1_worst)
    for name, worst in k23_worst.items():
        errs[name] = max(errs[name], worst)

    # -- phase 6 ------------------------------------------------------------
    errs.update(phase6(ct, hopper_cfft, hopper_small, tables, dev, rng))

    # -- phases 7-9: the paths, each read just after it runs -------------------
    capture = make_capture(rng)
    path5 = phase7(hf, models, stream, dev, capture)
    launches.update({k: v for k, v in path5.items() if k in (hopper_small.K5_COMPLEX.name, polyphase.DECIMATE.name)})
    path4 = phase8(hf, stream, dev, capture)
    launches[hopper_cfft.K4.name] = path4[hopper_cfft.K4.name]
    path_r = phase9(hf, stream, dev, x, h, ref)
    for k in (hopper_small.K5_REAL, hopper_small.K5_REAL_INVERSE):
        launches[k.name] = path_r[k.name]

    # -- phases 12-14: the composite kernels, config 2's top row, the reverb --
    errs.update(phase12(ct, hc, dev, rng))
    path2 = phase13(ct, hc, hf, dev, rng)
    for k in hc.KERNELS:
        launches[k.name] = path2[k.name]
    audio, ir = make_reverb(rng)
    phase14(ct, hc, hf, stream, dev, audio, ir)

    # -- phases 16-18: config 4, the STFT, the pipelined kernels -------------
    path4c, model_calls = phase16(models, hf, convolve, dev, audio, ir)
    launches[convolve.PARTITIONED.name] += path4c[convolve.PARTITIONED.name]
    phase17(stream, hf, dev, audio)
    db_errs, db_launches = phase18(ct, hf, hopper_cfft, lib, dev, rng, model_calls)
    errs.update(db_errs)
    launches.update(db_launches)

    # -- phase 20: gradients on the card ---------------------------------------
    t0 = time.perf_counter()
    backward, worst = phase20_functions(ct, hf, hopper_small, hc, autodiff, dev, 20261017)
    log("phase 20 Functions ok in " + f"{time.perf_counter() - t0:.1f} s; worst share of each bound: "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    phase20_timing(ct, hf, autodiff, dev, card)
    for k, v in phase20_training(hf, stream, models, dev, rng, card, x, h, ref, audio, ir).items():
        backward[k] = backward.get(k, 0) + v
    log(f"phase 20 ok in {time.perf_counter() - t0:.1f} s; backward launches {backward}")

    # -- phase 21: the parallel layer on a one-rank NCCL group -----------------
    parallel_launches = phase21(hf, hopper_small, convolve, models, stream, roof, dev, card, x, h, ref, audio, ir,
                                capture)

    # -- phase 22: the last modules (planner, plans, merge, adapters, profiling) --
    adapter_launches = phase22(ct, hf, hopper_small, hc, stream, models, dev, card, times[hf.K1.name]["device_ms"],
                               audio, ir)

    # -- phase 23: the offline FDL's kernel ----------------------------------------
    fdl_err, times[convolve.PARTITIONED.name], fdl_roof = phase23(_cuda, convolve, roof, lib_path, dev, card)
    errs[convolve.PARTITIONED.name] = fdl_err

    # -- phase 24: the polyphase decimator -------------------------------------
    errs[polyphase.DECIMATE.name], times[polyphase.DECIMATE.name], decim_roof = phase24(
        _cuda, polyphase, roof, lib, lib_path, dev, card)

    # -- phase 10 -------------------------------------------------------------
    for k in hf.KERNELS + convolve.KERNELS + polyphase.KERNELS:
        require(launches[k.name] > 0, f"{k.name} was not launched on its path")
    for n, kind in ((256, "complex"), (1024, "complex"), (4096, "complex"), (hf.MAX_CN, "complex"),
                    (8, "complex"), (480, "complex"), (256, "real"), (32, "real"), (16384, "complex"),
                    (1 << 19, "real"), (1 << 20, "real"), (1 << 20, "complex")):
        require(ct.engine_for(n, kind) == "hopper", f"engine_for({n}, {kind}) = {ct.engine_for(n, kind)}")
    for n, kind in ((6, "real"), (576, "real"), (1458, "real")):
        require(ct.engine_for(n, kind) == "stockham", f"engine_for({n}, {kind}) = {ct.engine_for(n, kind)}")
    log(f"phase 10 ok: every kernel carried its path; launches {launches}")

    # -- phases 11, 15 and 19: timing --------------------------------------------
    times.update(phase11(ct, hopper_cfft, hopper_small, row_passes, models, stream, lib, dev, capture, x, h, card))
    del capture
    times.update(phase15(ct, hc, roof, stream, lib, dev, card, audio, ir))
    times.update(phase19(ct, hf, hopper_cfft, roof, row_passes, lib, models, stream, dev, card, audio, ir, model_calls))
    del model_calls
    # The db forms compute their grid kernels' functions at the same shape.
    for db, grid in ((hf.K1_DB, hf.K1), (hf.K2_DB, hf.K2), (hopper_cfft.K4_DB, hf.K4)):
        times[db.name].update(library_ms=times[grid.name]["library_ms"],
                              library_device_ms=times[grid.name]["library_device_ms"])

    # Bounds at each kernel's timed shape (phases 5, 11 and 19; phase 15's
    # come with its times).
    n, rows = HEADLINE
    k3_bytes = rows * roof.fft_bytes(n, "real") + 4 * n  # A in, x out, one shared B
    k3_flops = rows * (2.5 * n * np.log2(n) + 3 * n)
    bounds = {
        hf.K1.name: roof.fft_roofline(n, rows, "real"),
        hf.K2.name: roof.fft_roofline(n, rows, "real"),
        hf.K3.name: roof.roofline(k3_bytes, k3_flops),
        hf.K4.name: roof.fft_roofline(n, rows, "complex"),
        hopper_small.K5_COMPLEX.name: roof.fft_roofline(*SMALL_TIMED, "complex"),
        hopper_small.K5_REAL.name: roof.fft_roofline(*SMALL_TIMED, "real"),
        hopper_small.K5_REAL_INVERSE.name: roof.fft_roofline(*SMALL_TIMED, "real"),
        hf.K1_DB.name: roof.fft_roofline(n, rows, "real"),
        hf.K2_DB.name: roof.fft_roofline(n, rows, "real"),
        hopper_cfft.K4_DB.name: roof.fft_roofline(n, rows, "complex"),
    }
    bounds.update({k.name: times[k.name]["bound"] for k in hc.KERNELS})
    bounds[convolve.PARTITIONED.name] = fdl_roof
    bounds[polyphase.DECIMATE.name] = decim_roof
    direct = roof.direct_dft_roofline(*SMALL_TIMED, "complex")
    k5 = times[hopper_small.K5_COMPLEX.name]
    log(f"K5 complex at N={SMALL_TIMED[0]}, B={SMALL_TIMED[1]}: the direct DFT of the old design did "
        f"{direct.flops / 1e9:.1f} GFLOP, bound at {direct.ms:.4f} ms ({direct.bound_by}); the FFT now takes "
        f"{k5['device_ms']:.4f} ms on the device ({k5['ms']:.4f} ms a call), against the function's bound "
        f"{bounds[hopper_small.K5_COMPLEX.name].ms:.4f} ms ({bounds[hopper_small.K5_COMPLEX.name].bound_by}) [{card}]")

    kernels = []
    for k in hf.KERNELS + convolve.KERNELS + polyphase.KERNELS:
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "max_abs_err": errs[k.name],
            "ms": times[k.name]["ms"], "plain_ms": times[k.name]["plain_ms"],
            "bound_ms": bounds[k.name].ms, "bound_by": bounds[k.name].bound_by,
            "library_ms": times[k.name]["library_ms"],
            "device_ms": times[k.name]["device_ms"], "library_device_ms": times[k.name]["library_device_ms"],
            "backward_launches": backward.get(k.name, 0),
            "parallel_launches": parallel_launches[k.name],
            "adapter_launches": adapter_launches.get(k.name, 0),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    result = {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
