"""Build the port's kernels on an NVIDIA GPU, time them, and run the
full-width paths that no card test covers.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc``, ``g++`` and the repo checkout (the kernels
are built from ``chowdsp_fft_tpu_torch/csrc`` into ``build/hopper/`` on
first use, the native planner from ``native/planner.cpp`` into
``build/native/``). Each kernel is checked against its plain version and
float64 by the tests marked ``cuda`` in tests/test_torch_cuda.py,
tests/test_torch_tracing.py, tests/test_torch_partitioned_accumulate.py,
tests/test_torch_polyphase_kernel.py, tests/test_torch_demod_kernel.py and
tests/test_torch_packed_product.py (``python -m pytest -m cuda`` on those
six files; run them first); here
each timed kernel is held to its plain version once more at the shape its
path gives it.

Phases (numbered as PERF.md cites them; there are no phases 2, 6 and
12), each of which asserts:

1. identify the card (name and power limit), build the kernels (one nvcc
   per source, in parallel), check the size limits (MAX_N, MAX_CN,
   MAX_SMALL_N, MAX_COL) and K5's and the K1-K4 row engine's points per
   thread against Python's, report ptxas's registers and spills of the
   row engine's kernels (K1-K4, K1-db, K2-db, K4-db) and of the column
   engine's (K6's four roles and its two packed forms, K7a, K7b);
3. BASELINE config 3 end to end: a 4096-tap FIR on 4 x 2^20-sample
   streams through ``stream.fir_filter_ols(block=8192)`` and
   ``stream.partitioned_fir_apply(block=1024)``, against a float64 FFT
   convolution (atol 5e-4 and 1e-3), plus ``PartitionedFIR.step_k``
   streaming against the offline result;
4. K1-K3, the offline FDL's partitioned accumulate and (in ``step_k``)
   the packed product carried config 3:
   every launch count from phase 3 > 0, and ``engine_for`` picks the
   Hopper engine at the path's sizes (the kernels line counts the
   product's launches from phase 14);
5. timing at N=4096, B=1024 (kernel, plain version, cuFFT), informational,
   with K1-K3's launch geometry and resident blocks per SM;
7. BASELINE config 5 at its published width: ``models.SDRChain`` (256
   channels) on one 2^24-sample capture of FM carriers plus noise,
   against float64 definitions (scipy ``upfirdn`` decimators, the
   channelizer's mixer definition): channelizer output, the occupied
   channels' audio, each carrier's power in its channel; K5, two
   launches of the polyphase decimator and one of the FM discriminator
   carried it;
8. a K4 path: ``stream.channelize`` with C = 1024 on the same capture,
   against the mixer definition and against the same channelizer on K4's
   plain version (every bin, 2e-7*C of the peak); K4 carried it;
9. a K5-real path: ``PartitionedFIR(h, block=128)`` on config 3's streams
   (N = 256), ``step_k`` against ``partitioned_fir_apply`` and float64;
   both real K5 bodies carried it;
10. coverage: every kernel record (``hopper_fft.KERNELS``,
    ``convolve.KERNELS``, ``polyphase.KERNELS`` and ``demod.KERNELS``)
    launched on its path,
    ``engine_for`` at the complex, small and composite sizes;
11. timing (informational): K4 at N=4096, B=1024 against ``torch.fft.fft``,
    K5 at N=256, B=32768 against ``torch.fft.ifft`` / ``rfft`` / ``irfft``
    (inverses unscaled, ``norm="forward"``, as the kernels are), each
    kernel's plain version, K4's and K5's launch geometry and resident
    blocks per SM;
13. BASELINE config 2's top row: ``fft``/``ifft``/``rfft_packed``/
    ``irfft_packed`` with ``engine="auto"`` at N=2^20, B=64, every row
    against float64 on the card (each inverse on its forward's output)
    and the round trips against the input, bound 2e-7*N; each composite
    kernel carried it;
14. a convolution reverb: ``stream.fir_filter_ols`` of 64 channels x 10 s
    at 48 kHz with per-channel 2 s impulse responses (N = 2^19), 8
    channels against a float64 FFT convolution and all 64 against the
    same call on the Stockham engine with the packed product's plain
    version (no kernel of the port); K7a, K6 level 2 and its reverse, K7b
    and the line transforms' K4 carried it, and the packed product ran
    exactly once (the kernels line's count for it);
15. timing (informational): each composite kernel at config 2's top row
    against its plain version, its bound (``utils/roofline.py``) and the
    matching ``torch.fft`` call, with the column engine's launch geometry
    and resident blocks per SM there; K6 level 2 and its reverse on the
    real composite's planes; K7a at the reverb's shape; K6 level 2 and
    l2_rev at the long-IR shape, packed against unpacked (with and without
    the torch assembly the packed forms replace);
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
18. the pipelined kernels on the paths: K2-db ``torch.equal`` to K2 at
    every size of K2's domain (1, 7 and 1001 rows, both orders); K1-db
    and K2-db ``torch.equal`` to K1 and K2 on config 4's own frames and
    accumulated spectra (recorded on phase 16's path) and to the model's
    outputs. Then their own run, counted: config 4's frames and spectra
    through K1-db and K2-db, the channelizer's transform through K4-db;
19. timing (informational): each db kernel beside its grid kernel
    (grid/db/db/grid in turn) at the headline shape, N = 16384, ragged
    batches, a single row, the channelizer's batch and config 4's frames
    and spectra, plain versions at the headline shape; K1 at config 4's
    7552 x 8192 frames and the STFT's 60,096 x 1024, K2 on config 4's
    accumulated spectra and at config 3's block 1024 (4096 x 2048), K3 at
    config 3's fir_filter_ols (512 x 16384, a shared filter), K4 backward
    at the channelizer's 16384 x 1024, each beside its ``torch.fft`` call
    (K3 beside the inverse alone) and bound, with the launch geometry and
    resident blocks per SM;
20. the training slice (``ops/autodiff.py``): an impulse response learned
    with Adam from zero on config 3's streams (5 steps; K1 + K3 forward,
    K1 + K2 backward) and on the reverb (3 steps; the composite both
    ways), the loss falling at every step, the first gradient against the
    Stockham engine and float64 (2e-7*N of its largest value; a zeroed
    gradient fails), the kernels each backward launched; and config 4's
    ``apply`` differentiated with respect to x, 8 channels against the
    Stockham engine;
21. the parallel layer on a one-rank NCCL group (``dsp_mesh(1)`` on the
    card: the halo hop has no operations, each all_to_all is a copy):
    config 3's ``sharded_fir_ols`` and ``sharded_partitioned_fir`` against
    float64, config 4's ``time_sharded_apply`` and
    ``channel_sharded_apply`` at full width against ``apply``, config 5's
    ``SDRChain.sharded_step`` on the 2^24-sample capture against the
    unsharded chain (occupied channels), the distributed FFT at 2^20 x 64
    and at 2^24 x 2 (above the single-card composite) against float64
    (a zeroed output and a real spectrum without its DC/Nyquist slots
    fail), and the sharded circular convolutions at 2^20 x 8;
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
23. timing (informational) of the offline FDL's kernel
    (``ops/convolve.convolve_accumulate_partitioned``,
    ``csrc/partitioned_accumulate.cu``): ptxas's registers of each
    sub-ring count, and at the reverb's 64 x 118 x 4096 with P = 24 (a
    filter per stream), config 3's 4 x 1024 x 1024 at block 1024 (P = 4,
    shared), one stream of 938 blocks the wrapper splits into runs (P =
    24) and P = 80 (passes of 32, shared) the kernel's geometry and time
    beside its plain version's and its bound (X and H read once, Y
    written once).
24. the polyphase decimator (``ops/polyphase.decimate_kernel``,
    ``csrc/polyphase.cu``): the library's limits against Python's; then
    (informational) ptxas's registers, and at config 5's front end (2 x
    2^24, f = 2, 64 taps) on I and Q planes and on the interleaved capture
    (a sample stride of 2), and its audio filter (256 x 32768, f = 4, 64
    taps) on contiguous rows and channel-fastest (a sample stride of
    256), the kernel's geometry and time beside its plain version's
    (framed cuDNN convolutions), cuDNN's strided ``conv1d`` on the
    unframed rows (the yardstick, ``library_ms``) and its bound (x read
    once, y written once), with the gap to the bound.
25. the FM discriminator (``ops/demod.fm_demod_kernel``,
    ``csrc/demod.cu``): ptxas's registers and spills (none allowed); then
    (informational) at config 5's 256 x 32768, channel-fastest (the
    channelizer's output) and on contiguous rows, the kernel's layout and
    time beside its plain version's (the torch ops, its sample 0 set to
    the kernel's 0) and its bound (z read once, y written once), with the
    gap to the bound.
26. the packed product (``ops/convolve.packed_product_kernel``,
    ``csrc/packed_product.cu``): ptxas's registers and spills (none
    allowed); then at the long-IR cell's 64 x 2 x 2^18 with a filter per
    stream, with a shared filter, and per stream with an accumulator, the
    kernel bit for bit its plain version (the torch ops), and
    (informational) its width, frames a unit and grid, its time beside
    the plain version's and its bound (a, the filter and y once).

Every timed kernel (phases 5, 11, 15, 19, 23-26) is first held to its
plain version on the same input (``kernel_times``: 2e-7*N at the
kernel's length and scale, ``held``; the FDL and the decimator within
1e-5 of the plain output's rms, the discriminator within 5e-7 absolute,
the packed product bit for bit),
then timed twice: ``ms``, CUDA events
around 20 calls from Python (host-inclusive: the wrapper, ctypes and the
launch), and ``device_ms``, the same 20 calls captured in one CUDA graph
and replayed (``graph_time_ms``: no host in the loop); the matching
``torch.fft`` call likewise (``library_ms``, ``library_device_ms``).

Phases run in the order 1, 3-5, 7-9, 13, 14, 16-18, 20-26, 10, 11, 15,
19. The line before the last is the kernel report as JSON, one entry for
each record of ``hopper_fft.KERNELS``, ``convolve.KERNELS``,
``polyphase.KERNELS`` and ``demod.KERNELS`` (with each kernel's ``max_abs_err`` against its
plain version at its timed shape, its launches in phase 20's training
slice, ``backward_launches``, on phase 21's parallel paths,
``parallel_launches``, and on phase 22's paths, ``adapter_launches``);
the last line is ``{"ok": true,
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
K4_PATH = (1024, CONFIG5_SAMPLES // 1024)  # K4 at phase 8's channelizer shape


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


def held(n: int, length: int | None = None, scale: float = 1.0):
    """The bound on max |kernel - plain| of a kernel of transform length
    ``length`` (default ``n``) on the path of an N-point transform, as a
    function of the plain output's rms: on the outputs times ``scale``
    (1/N after an unnormalised inverse), 2e-7*N, or 2e-7*length times
    their rms where that is smaller. An intermediate is thus held below
    its own size: a zeroed output or a dropped bin fails."""
    return lambda rms: TOL * min(n, (length or n) * rms * scale) / scale


def rms_share(share: float):
    """The bound on max |kernel - plain| as ``share`` of the plain output's
    rms (kernels whose float32 sums run in another order, not FFTs)."""
    return lambda rms: share * rms


SUM_ORDER_GAP = 1e-5  # the FDL's and the decimator's bound, of the plain output's rms


def against_plain(fn, plain, args, bound) -> float:
    """max |fn(*args) - plain(*args)| over every output plane, in float64
    on the card; raises past ``bound`` of the plain output's rms."""
    got, want = as_tuple(fn(*args)), as_tuple(plain(*args))
    require(len(got) == len(want), f"{len(got)} outputs against the plain version's {len(want)}")
    wide = torch.complex128 if any(t.is_complex() for t in got + want) else torch.float64
    g = torch.cat([t.reshape(-1).to(wide) for t in got])
    w = torch.cat([t.reshape(-1).to(wide) for t in want])
    err = float((g - w).abs().max())
    limit = bound(float(w.abs().pow(2).mean().sqrt()))
    require(err <= limit, f"max |kernel - plain| {err:.3e} > {limit:.3e}")
    return err


def kernel_times(fn, plain, args_list, library=None, library_args=None, *, bound) -> dict:
    """A kernel's row of the report at one shape: its max abs error
    against its plain version on ``args_list[0]`` (within ``bound``, see
    :func:`against_plain`), its host-inclusive and device ms, its plain
    version's host-inclusive ms, and the same two times of the PyTorch
    call that computes the same function (None where there is none), on
    ``library_args`` (default: the kernel's)."""
    err = against_plain(fn, plain, args_list[0], bound)
    lib_ms = lib_device_ms = None
    if library is not None:
        lib_args = library_args or args_list
        lib_ms, lib_device_ms = time_ms(library, lib_args), graph_time_ms(library, lib_args)
    return {"max_abs_err": err, "ms": time_ms(fn, args_list), "device_ms": graph_time_ms(fn, args_list),
            "plain_ms": time_ms(plain, args_list), "library_ms": lib_ms, "library_device_ms": lib_device_ms}


def log_times(phase: int, name: str, shape: str, t: dict, card: str) -> None:
    lib = ("none" if t["library_ms"] is None
           else f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f} ms)")
    log(f"phase {phase} {name} {shape}: max |kernel - plain| {t['max_abs_err']:.3e}; kernel {t['ms']:.4f} ms "
        f"(device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, library {lib} [{card}]")


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
    from chowdsp_fft_tpu_torch.ops import demod, polyphase

    cfg = models.SDRChainConfig()
    require(cfg.channels == 256, "config 5 is the 256-channel chain")
    chain = models.SDRChain(cfg, device=dev)
    iq = torch.from_numpy(capture).to(dev)
    hf.reset_launch_counts()
    polyphase.DECIMATE.launches = demod.FM_DEMOD.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    audio = chain(iq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS + polyphase.KERNELS + demod.KERNELS}
    require(launches[polyphase.DECIMATE.name] == 2, f"config 5 launched the decimator "
            f"{launches[polyphase.DECIMATE.name]} times, not once for each of its two decimators")
    require(launches[demod.FM_DEMOD.name] == 1,
            f"config 5 launched the discriminator {launches[demod.FM_DEMOD.name]} times, not once")
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
        # (sample 0 has no phase history: 0 on the card, atan2 of signed zeros in the JAX package)
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
# Phase 11: timing of K4 and K5
# ---------------------------------------------------------------------------


def phase11(ct, hopper_cfft, hopper_small, row_passes, lib, dev, card) -> dict[str, dict]:
    """K4 at the headline shape and the three K5 bodies at N=256, B=32768
    (kernel_times; the inverse library calls unscaled, norm="forward", as
    the kernels are), K4's and K5's launch geometry and resident blocks
    per SM."""
    times: dict[str, dict] = {}
    n, rows = HEADLINE
    plan = ct.cached_plan(n, ct.FFT_COMPLEX)
    args = [(torch.randn(rows, n, dtype=torch.complex64, device=dev),) for _ in range(4)]
    times[hopper_cfft.K4.name] = kernel_times(lambda z: hopper_cfft.cfft_kernel(z, plan, True, True),
                                              lambda z: hopper_cfft.cfft_plain(z, plan, True, True), args,
                                              lambda z: torch.fft.fft(z), bound=held(n))
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
        lambda z: hopper_small.small_cfft_plain(z, cplan, False), zs, lambda z: torch.fft.ifft(z, norm="forward"),
        bound=held(n, scale=1 / n))
    times[hopper_small.K5_REAL.name] = kernel_times(
        lambda v: hopper_small.small_rfft_kernel(v, rplan),
        lambda v: hopper_small.small_rfft_plain(v, rplan), xs, lambda v: torch.fft.rfft(v), bound=held(n))
    times[hopper_small.K5_REAL_INVERSE.name] = kernel_times(
        lambda r, i: hopper_small.small_irfft_kernel(r, i, rplan),
        lambda r, i: hopper_small.small_irfft_plain(r, i, rplan), specs,
        lambda c: torch.fft.irfft(c, n=n, norm="forward"), cspecs, bound=held(n, scale=1 / n))
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
    return times


# ---------------------------------------------------------------------------
# Phase 13: BASELINE config 2's top row; phase 14: the long-IR reverb
# ---------------------------------------------------------------------------

CONFIG2_TOP = (1 << 20, 64)  # BASELINE config 2's largest N, at bench.py's batch of 64
REVERB = {"channels": 64, "seconds": 10, "ir_seconds": 2, "rate": 48000}
REVERB_ATOL = 1e-3  # vs float64: config 3's atol; the wet signal's rms is ~0.8 here
REVERB_ENGINE_ATOL = 2e-4  # vs the same call on the Stockham engine (two float32 paths)


def phase13(ct, hc, hf, dev) -> dict[str, int]:
    """ct.fft / ifft / rfft_packed / irfft_packed with engine="auto" at
    N = 2^20, B = 64: every row against float64 on the card (``torch.fft``
    in float64: a reference, not the port), each inverse on its forward's
    output and the round trips against the input; each composite kernel
    carried it."""
    n, rows = CONFIG2_TOP
    bound = TOL * n
    for kind in ("complex", "real"):
        require(ct.engine_for(n, kind) == "hopper", f"engine_for({n}, {kind}) = {ct.engine_for(n, kind)}")
    z = torch.randn(rows, n, dtype=torch.complex64, device=dev)
    x = torch.randn(rows, n, device=dev)
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
    # Packed planes hold bins 0..N/2-1, the Nyquist bin's real part in im[0].
    half = torch.fft.rfft(x.double())
    ref_im = half.imag[:, : n // 2].clone()
    ref_im[:, 0] = half.real[:, n // 2]
    nyq = im[:, :1].double()
    spec = torch.cat([torch.complex(re.double(), im.double()), torch.complex(nyq, torch.zeros_like(nyq))], -1)
    spec[:, 0] = re[:, 0].double()
    errs = {
        "fft": max_err(y, torch.fft.fft(z.to(torch.complex128))),
        "ifft": max_err(zb / n, torch.fft.ifft(y.to(torch.complex128))),
        "ifft(fft(z)) / N vs z": max_err(zb / n, z),
        "rfft_packed": max(max_err(re, half.real[:, : n // 2]), max_err(im, ref_im)),
        "irfft_packed": max_err(xb / n, torch.fft.irfft(spec, n=n)),
        "irfft_packed(rfft_packed(x)) / N vs x": max_err(xb / n, x),
    }
    for key, err in errs.items():
        require(err <= bound, f"config 2 top row {key}: {err:.3e} > {bound:.3e}")
    log("phase 13 ok, every row vs float64: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {bound:.3e})")
    return launches


def make_reverb(rng) -> tuple[np.ndarray, np.ndarray]:
    """64 channels x 10 s of noise at 48 kHz and per-channel 2 s impulse
    responses of exponentially decaying noise (examples/02_convolution_reverb.py)."""
    c, sr = REVERB["channels"], REVERB["rate"]
    taps = REVERB["ir_seconds"] * sr
    ir = rng.standard_normal((c, taps)) * np.exp(-np.linspace(0, 8, taps)) / 100
    audio = rng.standard_normal((c, REVERB["seconds"] * sr))
    return audio.astype(np.float32), ir.astype(np.float32)


def phase14(ct, hc, hf, convolve, stream, dev, audio: np.ndarray, ir: np.ndarray) -> dict[str, int]:
    """stream.fir_filter_ols(audio, ir) with engine="auto": N = 2^19 and
    2 blocks per channel, 128 rows through K7a, K6 level 2, the line
    transforms (K4 at C = 512), K6 level-2 reverse and K7b, and one launch
    of the packed product; held to float64 and to the Stockham engine with
    the product's plain version."""
    x = torch.from_numpy(audio).to(dev)
    h = torch.from_numpy(ir).to(dev)
    taps = ir.shape[-1]
    n = stream.next_fft_size(max(256, stream.next_fft_size(4 * taps) // 2) + taps - 1)
    a, c = hc.split_large(n, real=True)
    require(n == 1 << 19 and ct.engine_for(n, "real") == "hopper", f"reverb N={n}, {ct.engine_for(n, 'real')}")
    hf.reset_launch_counts()
    product = convolve.PACKED_PRODUCT
    product.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wet = stream.fir_filter_ols(x, h)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in hf.KERNELS + (product,)}
    log(f"phase 14 reverb (64 ch x 10 s, 2 s IRs, N={n} = {a}x{c}) ran in {wall:.3f} s (first call, host clock); "
        f"launches {launches}")
    for k in (hc.K7A, hc.K6_L2, hc.K6_L2_REV, hc.K7B, hf.K4):
        require(launches[k.name] > 0, f"{k.name} was not launched on the reverb path")
    require(launches[product.name] == 1, f"the reverb launched {product.name} {launches[product.name]} times, not once")
    require(tuple(wet.shape) == audio.shape and bool(torch.isfinite(wet).all()), f"wet {tuple(wet.shape)}")
    got = wet[:8].double().cpu().numpy()
    ref = fft_convolve64(audio[:8].astype(np.float64), ir[:8].astype(np.float64))
    err64 = float(np.abs(got - ref).max())
    rms = float(np.sqrt((ref ** 2).mean()))
    kernel = convolve.packed_product_kernel
    convolve.packed_product_kernel = convolve.convolve_accumulate_packed_plain
    try:
        plain = stream.fir_filter_ols(x, h, engine="stockham")
    finally:
        convolve.packed_product_kernel = kernel
    require(product.launches == 1, f"the Stockham reverb launched {product.name}")
    err_eng = float((wet - plain).abs().max())
    log(f"phase 14 reverb: 8 channels vs float64 max abs err {err64:.3e} (atol {REVERB_ATOL}, wet rms {rms:.3f}); "
        f"64 channels vs engine=stockham and the plain product {err_eng:.3e} (atol {REVERB_ENGINE_ATOL})")
    require(err64 <= REVERB_ATOL, f"reverb vs float64: {err64} > {REVERB_ATOL}")
    require(err_eng <= REVERB_ENGINE_ATOL, f"reverb vs stockham: {err_eng} > {REVERB_ENGINE_ATOL}")
    log("phase 14 ok")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: timing of the composite kernels
# ---------------------------------------------------------------------------


def phase15(ct, hc, roof, lib, dev, card) -> dict[str, dict]:
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
                                      lambda v: torch.fft.fft(v, dim=1), bound=held(n, a))
    out[hc.K6_L1.name]["bound"] = roof.level_roofline(n, rows, a)
    out[hc.K6_L2.name] = kernel_times(lambda v: hc.level2(v, tw, pc, True),
                                      lambda v: hc.level2_plain(v, tw, pc, True), mids, bound=held(n, c))
    out[hc.K6_L2.name]["bound"] = roof.level_roofline(n, rows, c, table_points=n)
    out[hc.K6_L2_REV.name] = kernel_times(lambda v: hc.level2(v, twb, pc, False),
                                          lambda v: hc.level2_plain(v, twb, pc, False), mids,
                                          bound=held(n, c, 1 / n))
    out[hc.K6_L2_REV.name]["bound"] = roof.level_roofline(n, rows, c, table_points=n)
    out[hc.K6_L1_REV.name] = kernel_times(lambda v: hc.level1(v, pa, False),
                                          lambda v: hc.level1_plain(v, pa, False), mids,
                                          lambda v: torch.fft.ifft(v, dim=-1, norm="forward"), bound=held(n, a, 1 / n))
    out[hc.K6_L1_REV.name]["bound"] = roof.level_roofline(n, rows, a)
    del zs, x3, mids

    ra, rc = hc.split_large(n, real=True)
    pra = ct.cached_plan(ra, ct.FFT_REAL)
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
        t = kernel_times(lambda v: hc.level2(v, twt, prc, fwd), lambda v: hc.level2_plain(v, twt, prc, fwd), grids,
                         bound=held(n, rc))
        log_times(15, k.name, f"planes of the real composite (B=64, C={rc}, A/2={ra // 2}; bound "
                              f"{planes_bound.ms:.4f} ms, {planes_bound.bound_by})", t, card)
    del grids
    phase15_packed(ct, hc, roof, lib, dev, card)
    xs = [(torch.randn(rows, n, device=dev),) for _ in range(2)]
    xr3 = [(x.reshape(rows, ra, rc),) for (x,) in xs]
    packed = [hc.rfft_cols(v, pra) for (v,) in xr3]
    out[hc.K7A.name] = kernel_times(lambda v: hc.rfft_cols(v, pra), lambda v: hc.rfft_cols_plain(v, pra), xr3,
                                    lambda v: torch.fft.rfft(v, dim=1), bound=held(n, ra))
    out[hc.K7A.name]["bound"] = roof.level_roofline(n, rows, ra, "real")
    # K7a at the reverb's shape (N = 2^19, two blocks a channel: the same
    # bytes as config 2's top row).
    vn, vrows = 1 << 19, 2 * REVERB["channels"]
    va, vc = hc.split_large(vn, real=True)
    pva = ct.cached_plan(va, ct.FFT_REAL)
    xv = [(torch.randn(vrows, va, vc, device=dev),) for _ in range(2)]
    t = kernel_times(lambda v: hc.rfft_cols(v, pva), lambda v: hc.rfft_cols_plain(v, pva), xv,
                     lambda v: torch.fft.rfft(v, dim=1), bound=held(vn, va))
    vb = roof.level_roofline(vn, vrows, va, "real")
    log_times(15, hc.K7A.name, f"at the reverb's shape (N=2^19, B={vrows}, A={va}, C={vc}; bound {vb.ms:.4f} ms, "
                               f"{vb.bound_by})", t, card)
    del xv
    specs = [(torch.fft.rfft(v.transpose(1, 2), dim=-1),) for (v,) in xr3]
    out[hc.K7B.name] = kernel_times(lambda r, i: hc.irfft_cols(r, i, pra),
                                    lambda r, i: hc.irfft_cols_plain(r, i, pra), packed,
                                    lambda sp: torch.fft.irfft(sp, n=ra, dim=-1, norm="forward"), specs,
                                    bound=held(n, ra, 1 / ra))
    out[hc.K7B.name]["bound"] = roof.level_roofline(n, rows, ra, "real")
    del specs, xs, xr3, packed

    for k in hc.KERNELS:
        log_times(15, k.name, f"(N=2^20, B=64; bound {out[k.name]['bound'].ms:.4f} ms, "
                              f"{out[k.name]['bound'].bound_by})", out[k.name], card)
    return out


def phase15_packed(ct, hc, roof, lib, dev, card) -> None:
    """K6 level 2 and l2_rev of the real composite at the long-IR cell's
    shape (N = 2^19: 192 rows forward, the IRs' and the frames', 128
    inverse), device ms by graph replay: the packed forms (the path's),
    the unpacked kernels alone, and the unpacked kernels with the torch
    assembly they replace, which the packed outputs equal bit for bit;
    with the packed forms' launch geometry and resident blocks per SM."""
    from chowdsp_fft_tpu_torch.ops import col_passes

    n = 1 << 19
    a, c = hc.split_large(n, real=True)
    plan = ct.cached_plan(c, ct.FFT_COMPLEX)
    tw, twb = hc.real_twiddle(n, True, dev), hc.real_twiddle(n, False, dev)
    for rows, fwd in ((192, True), (128, False)):
        k = hc.K6_L2 if fwd else hc.K6_L2_REV
        g = col_passes.launch_geometry(plan, rows, a // 2, 4, hc.in_place_role(k, 1))
        log(f"phase 15 {k.name} packed geometry (L={c}): passes {g.passes}, {g.lanes} columns and {g.threads} threads "
            f"a block, {g.buffers} tile buffer(s) of {g.smem_bytes} B; "
            f"{lib.hopper_composite_blocks_per_sm(6 if fwd else 7, g.shape, g.threads, g.smem_bytes)} resident "
            f"blocks per SM")
        if fwd:
            args = [(torch.randn(rows, c, a // 2, device=dev), torch.randn(rows, c, a // 2, device=dev),
                     torch.randn(2 * rows, c, dtype=torch.complex64, device=dev)) for _ in range(2)]
            forms = {"packed": lambda r, i, g: hc.level2_packed(r, i, tw, plan, g),
                     "unpacked": lambda r, i, g: hc.level2((r, i), tw, plan, True),
                     "unpacked + assembly": lambda r, i, g: hc.hermitian_assembly(*hc.level2((r, i), tw, plan, True),
                                                                                   g)}
        else:
            args = [(torch.randn(rows, n // 2, device=dev), torch.randn(rows, n // 2, device=dev),
                     torch.randn(rows, c, dtype=torch.complex64, device=dev)) for _ in range(2)]
            forms = {"packed": lambda r, i, c0: hc.level2_rev_packed(r, i, c0, twb, plan),
                     "unpacked": lambda r, i, c0: hc.level2((r.view(rows, c, a // 2), i.view(rows, c, a // 2)), twb,
                                                            plan, False),
                     "unpacked + assembly": lambda r, i, c0: hc.level2(hc.hermitian_grid(r, i, c0), twb, plan, False)}
        got, want = forms["packed"](*args[0]), forms["unpacked + assembly"](*args[0])
        require(all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)),
                f"phase 15 {k.name} packed differs from the unpacked kernel with the torch assembly")
        times = {name: graph_time_ms(fn, args) for name, fn in forms.items()}
        times["packed, again"] = graph_time_ms(forms["packed"], args)
        bound = roof.level_roofline(n // 2, rows, c, table_points=n // 2)
        log(f"phase 15 {k.name} real composite at the long-IR shape (N=2^19, B={rows}, C={c}, A/2={a // 2}; bound "
            f"{bound.ms:.4f} ms, {bound.bound_by}): device ms "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
            + f"; packed/unpacked {times['packed'] / times['unpacked']:.3f}, bit for bit the assembly [{card}]")
        del args


# ---------------------------------------------------------------------------
# Phase 16: BASELINE config 4; phase 17: the STFT; phase 18: the pipelined
# kernels on the paths; phase 19: their timing
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


def phase18(ct, hf, hc4, lib, dev, rng, model_calls: dict) -> dict[str, int]:
    """K1-db, K2-db and K4-db on the paths that no card test runs: K2-db
    torch.equal to K2 at every size of K2's domain (1, 7 and 1001 rows,
    both orders); K1-db and K2-db on config 4's own frames and accumulated
    spectra (recorded on the model's path), torch.equal to K1 and K2 there
    and to the outputs the model produced. Then the pipelined forms' own
    run, counted: config 4's frames and spectra through K1-db and K2-db,
    the C=1024 channelizer's transform through K4-db. Returns the
    launches of that run."""
    db = (hf.K1_DB, hf.K2_DB, hc4.K4_DB)
    sweep = [n for n in range(257, hf.MAX_N + 1) if hf._in_domain(n)]
    for n in sweep:
        plan = ct.cached_plan(n, ct.FFT_REAL)
        for rows in (1, 7, 1001):
            x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
            for ordered in (True, False):
                re, im = hf.rfft_packed_kernel(x, plan, ordered)
                require(torch.equal(hf.irfft_packed_db_kernel(re, im, plan, ordered),
                                    hf.irfft_packed_kernel(re, im, plan, ordered)),
                        f"K2-db differs from K2 at N={n} rows={rows} ordered={ordered}")
    (frames, plan8k, ordered), (yre, yim) = model_calls["k1"]
    n8k, m8k = plan8k.n, plan8k.n // 2
    for order in (True, False):
        tag = f"config 4 frames ({frames.shape[0]} x {n8k}) {'ord' if order else 'unord'}"
        joint = hf.rfft_packed_joint_kernel(frames, plan8k, order)
        require(torch.equal(hf.rfft_packed_joint_db_kernel(frames, plan8k, order), joint), f"{tag}: K1-db differs from K1")
        re, im = hf.rfft_packed_kernel(frames, plan8k, order)
        require(torch.equal(joint[:, :m8k], re) and torch.equal(joint[:, m8k:], im), f"{tag}: joint K1 != planes")
        del joint
        require(torch.equal(hf.irfft_packed_db_kernel(re, im, plan8k, order), hf.irfft_packed_kernel(re, im, plan8k, order)),
                f"{tag}: K2-db differs from K2")
    joint_db = hf.rfft_packed_joint_db_kernel(frames, plan8k, ordered)
    require(torch.equal(joint_db[:, :m8k], yre) and torch.equal(joint_db[:, m8k:], yim),
            "K1-db differs from the model's K1 output")
    del joint_db
    (are, aim, _, k2_ordered), model_blocks = model_calls["k2"]
    require(torch.equal(hf.irfft_packed_db_kernel(are, aim, plan8k, k2_ordered), model_blocks),
            "K2-db differs from the model's K2 output")
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
    log(f"phase 18 ok: K2-db torch.equal to K2 at all {len(sweep)} sizes of its domain, both orders, 1, 7 and 1001 "
        f"rows; K1-db and K2-db torch.equal to K1 and K2 on config 4's frames and spectra, and to the model's own "
        f"outputs; blocks per SM {blocks_per_sm}; pipelined run launches {launches}")
    return launches


def phase19(ct, hf, hc4, roof, row_passes, lib, dev, card, audio_shape: tuple[int, int],
            model_calls: dict) -> dict[str, dict]:
    """Timing (informational). Each db kernel beside its grid kernel,
    grid/db/db/grid in turn, at the headline shape, N = 16384, ragged
    batches, a single row and config 4's frames and spectra (K1 and K1-db
    joint unordered, K2 unordered, K4 complex64 forward ordered); at the
    headline shape the db kernels' device times and plain versions; K1-K4
    at their paths' shapes. Returns each db kernel's row at the headline
    shape (ms, device_ms, plain_ms) and the path shapes' rows."""

    def alternate(grid_fn, db_fn, args):
        g1, d1 = time_ms(grid_fn, args), time_ms(db_fn, args)
        d2, g2 = time_ms(db_fn, args), time_ms(grid_fn, args)
        return (g1 + g2) / 2, (d1 + d2) / 2

    def report(name, shape, grid_ms, db_ms, bound):
        log(f"phase 19 A/B {name} {shape}: grid {grid_ms:.4f} ms, db {db_ms:.4f} ms, db/grid "
            f"{db_ms / grid_ms:.3f}; bound {bound.ms:.4f} ms ({bound.bound_by}) [{card}]")

    def db_times(db_fn, plain, args, host_ms, bound):
        """A db kernel's row: its max abs error against its plain version
        (within ``bound``), its A/B host-inclusive mean, its device time by
        graph replay, its plain version's time (the library columns are
        its grid kernel's)."""
        return {"max_abs_err": against_plain(db_fn, plain, args[0], bound), "ms": host_ms,
                "device_ms": graph_time_ms(db_fn, args), "plain_ms": time_ms(plain, args)}

    out: dict[str, dict] = {}
    for n, rows in REAL_DB_SHAPES:
        plan = ct.cached_plan(n, ct.FFT_REAL)
        xs = [(torch.randn(rows, n, device=dev),) for _ in range(2)]
        g, d = alternate(lambda v: hf.rfft_packed_joint_kernel(v, plan, False),
                         lambda v: hf.rfft_packed_joint_db_kernel(v, plan, False), xs)
        report("K1 / K1-db", f"N={n} B={rows}", g, d, roof.fft_roofline(n, rows, "real"))
        if (n, rows) == HEADLINE:
            out[hf.K1_DB.name] = db_times(lambda v: hf.rfft_packed_joint_db_kernel(v, plan, False),
                                          lambda v: hf.rfft_packed_joint_plain(v, plan, False), xs, d, held(n))
        specs = [hf.rfft_packed_kernel(v, plan, False) for (v,) in xs]
        g, d = alternate(lambda r, i: hf.irfft_packed_kernel(r, i, plan, False),
                         lambda r, i: hf.irfft_packed_db_kernel(r, i, plan, False), specs)
        report("K2 / K2-db", f"N={n} B={rows}", g, d, roof.fft_roofline(n, rows, "real"))
        if (n, rows) == HEADLINE:
            out[hf.K2_DB.name] = db_times(lambda r, i: hf.irfft_packed_db_kernel(r, i, plan, False),
                                          lambda r, i: hf.irfft_packed_plain(r, i, plan, False), specs, d,
                                          held(n, scale=1 / n))
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
                                           lambda v: hc4.cfft_plain(v, plan, True, True), zs, d, held(n))
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
    stft_rows = audio_shape[0] * -(-(audio_shape[1] + STFT[0] - STFT[1]) // STFT[1])  # 64 x 939 frames
    ols_plan = ct.cached_plan(2 * 8192, ct.FFT_REAL)
    ols_rows = CONFIG3["streams"] * CONFIG3["samples"] // 8192
    ols_args, ols_lib = spectra(ols_plan, ols_rows)
    ols_filt = tuple(t[:1].contiguous() for t in spectra(ols_plan, 1)[0][0])
    pfir_plan = ct.cached_plan(2 * 1024, ct.FFT_REAL)
    pfir_args, pfir_lib = spectra(pfir_plan, CONFIG3["streams"] * CONFIG3["samples"] // 1024)
    acc_lib = [(torch.fft.rfft(torch.randn(are.shape[0], plan8k.n, device=dev)),)]
    c_plan = ct.cached_plan(K4_PATH[0], ct.FFT_COMPLEX)
    paths = (  # (name, plan, args, kernel, plain, library, its args, unnormalised inverse)
        ("K1 config 4 frames", plan8k, [(frames,)], lambda v: hf.rfft_packed_kernel(v, plan8k, ordered),
         lambda v: hf.rfft_packed_plain(v, plan8k, ordered), lambda v: torch.fft.rfft(v), None, False),
        ("K2 config 4 accumulated spectra", plan8k, [(are, aim)],
         lambda r, i: hf.irfft_packed_kernel(r, i, plan8k, k2_ordered),
         lambda r, i: hf.irfft_packed_plain(r, i, plan8k, k2_ordered), irfft_lib(plan8k.n), acc_lib, True),
        ("K1 STFT frames", rplan4k, [(torch.randn(stft_rows, STFT[0], device=dev),)],
         lambda v: hf.rfft_packed_kernel(v, rplan4k), lambda v: hf.rfft_packed_plain(v, rplan4k),
         lambda v: torch.fft.rfft(v), None, False),
        ("K3 config 3 fir_filter_ols", ols_plan, ols_args,
         lambda r, i: hf.convolve_irfft_packed_kernel(r, i, *ols_filt, 1.0 / ols_plan.n, ols_plan, False),
         lambda r, i: hf.convolve_irfft_packed_plain(r, i, *ols_filt, 1.0 / ols_plan.n, ols_plan, False),
         irfft_lib(ols_plan.n), ols_lib, False),
        ("K2 config 3 block 1024", pfir_plan, pfir_args, lambda r, i: hf.irfft_packed_kernel(r, i, pfir_plan, False),
         lambda r, i: hf.irfft_packed_plain(r, i, pfir_plan, False), irfft_lib(pfir_plan.n), pfir_lib, True),
        ("K4 channelizer backward", c_plan, [(torch.randn(K4_PATH[1], K4_PATH[0], dtype=torch.complex64, device=dev),)],
         lambda v: hc4.cfft_kernel(v, c_plan, False, True), lambda v: hc4.cfft_plain(v, c_plan, False, True),
         lambda v: torch.fft.ifft(v, norm="forward"), None, True),
    )
    for name, plan, args, fn, plain, library, library_args, inverse in paths:
        rows = args[0][0].shape[0]
        tm = kernel_times(fn, plain, args, library, library_args,
                          bound=held(plan.n, scale=1 / plan.n if inverse else 1.0))
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
    return out


# ---------------------------------------------------------------------------
# Phase 20: the training slice on the card (ops/autodiff.py)
# ---------------------------------------------------------------------------

GRAD_CONV = (16384, 512)  # config 3's fir_filter_ols(block=8192): K3 on 512 rows of 16384
TRAIN_STEPS = {"config 3": 5, "reverb": 3}
TRAIN_LR = 0.1  # Adam's step over the mean |h*|: small against the error each tap starts with
GRAD_ENGINE_RTOL = 1e-4  # a gradient against the Stockham engine's, over its largest value (_grad_match)


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
             block, check_rows: int) -> dict[str, int]:
    """Fit an impulse response with Adam from zero: loss = mean((fir_filter_ols(x, h) - target)^2), target
    the float64 convolution with ``h_star``. The first gradient against the same call on the Stockham
    engine and against float64 (the cross-correlation of the residual with x, numpy, on ``check_rows``
    streams): 2e-7*N of the float64 gradient's largest value, the engine's bound for one N-point
    transform chain relative to its scale. The loss must fall at every step. Returns the backward
    passes' launches."""
    kw = {} if block is None else {"block": block}
    taps = h_star.shape[-1]
    n = stream.next_fft_size((block or max(256, stream.next_fft_size(4 * taps) // 2)) + taps - 1)

    def loss_of(param, engine="auto"):
        y = stream.fir_filter_ols(x, param, engine=engine, **kw)
        return ((y - target) ** 2).mean(), y

    h = torch.nn.Parameter(torch.zeros_like(h_star))
    lr = TRAIN_LR * float(h_star.abs().mean())
    opt = torch.optim.Adam([h], lr=lr)
    losses, backward = [], {}
    for step in range(steps):
        opt.zero_grad(set_to_none=True)
        loss, y = loss_of(h)
        hf.reset_launch_counts()
        loss.backward()
        launches = {k.name: k.launches for k in hf.KERNELS if k.launches}
        opt.step()
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
    with torch.no_grad():
        losses.append(float(loss_of(h)[0]))
    log(f"phase 20 {name}: losses {', '.join(f'{v:.9e}' for v in losses)} (lr {lr:.3e})")
    require(all(b < a for a, b in zip(losses, losses[1:])), f"{name}: the loss did not fall at every step {losses}")
    return backward


def phase20_training(hf, stream, models, dev, rng, x3, h3, ref3: np.ndarray, audio: np.ndarray,
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
    from chowdsp_fft_tpu_torch.ops import hopper_composite as hc

    backward: dict[str, int] = {}
    ran("phase 20 config 3 training backward",
        learn_ir(hf, stream, "config 3", x3, torch.from_numpy(ref3.astype(np.float32)).to(dev), h3,
                 TRAIN_STEPS["config 3"], 8192, x3.shape[0]), (hf.K1, hf.K2), backward)
    x = torch.from_numpy(audio).to(dev)
    h_star = torch.from_numpy(ir).to(dev)
    target = fft_convolve64_card(x, h_star).float()
    ran("phase 20 reverb training backward",
        learn_ir(hf, stream, "reverb", x, target, h_star, TRAIN_STEPS["reverb"], None, 8),
        (hc.K7A, hc.K6_L2, hc.K6_L2_REV, hc.K7B), backward)
    del target

    # Config 4: the gradient of MultichannelConvolver.apply with respect to x.
    channels = audio.shape[0]
    conv = models.MultichannelConvolver(ir, models.ConvolverConfig(channels=channels, block=CONFIG4_BLOCK), device=dev)
    w = torch.from_numpy(rng.standard_normal(audio.shape, dtype=np.float32)).to(dev)
    xv = x.clone().requires_grad_()
    loss = (conv.apply(xv) * w).sum()
    hf.reset_launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in hf.KERNELS if k.launches}
    ran("phase 20 config 4 gradient backward", launches, (hf.K1, hf.K2), backward)
    conv8 = models.MultichannelConvolver(ir[:8], models.ConvolverConfig(channels=8, block=CONFIG4_BLOCK,
                                                                        engine="stockham"), device=dev)
    x8 = x[:8].clone().requires_grad_()
    (conv8.apply(x8) * w[:8]).sum().backward()
    err = max_err(xv.grad[:8], x8.grad) / float(x8.grad.abs().max())
    log(f"phase 20 config 4 dL/dx ({channels} ch x {audio.shape[1]}): 8 channels vs engine=stockham {err:.3e} of its "
        f"largest value (rtol {GRAD_ENGINE_RTOL}); backward launches {launches}")
    require(err <= GRAD_ENGINE_RTOL, f"config 4 gradient vs stockham: {err} > {GRAD_ENGINE_RTOL}")
    require(bool(torch.isfinite(xv.grad).all()), "config 4 gradient: non-finite values")
    del conv, conv8, xv, x8, w, loss, x
    torch.cuda.empty_cache()
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


def phase21(hf, hs, convolve, models, dev, x3, h3, ref3: np.ndarray, audio: np.ndarray, ir: np.ndarray,
            capture: np.ndarray) -> dict[str, int]:
    """The parallel layer's paths on a one-rank NCCL group (a dsp_mesh(1) on
    the card): every local transform runs K1-K5 at full width, the halo
    hop has no operations and each all_to_all is a copy. Returns the
    kernels' launches on these paths."""
    import torch.distributed as dist
    from chowdsp_fft_tpu_torch import parallel

    t_phase = time.perf_counter()
    parallel.init_local_group("cuda")
    try:
        launches = phase21_paths(parallel, hf, hs, convolve, models, dev, x3, h3, ref3, audio, ir, capture)
    finally:
        dist.destroy_process_group()
    log(f"phase 21 ok in {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


def phase21_paths(parallel, hf, hs, convolve, models, dev, x3, h3, ref3, audio, ir, capture) -> dict[str, int]:
    from chowdsp_fft_tpu_torch.ops import demod, polyphase

    mesh = parallel.dsp_mesh(1)
    cmesh = parallel.dsp_mesh(1, axis=parallel.CHANNEL_AXIS)
    require(mesh.device_type == "cuda" and mesh.size() == 1, f"mesh {mesh}")
    kernels = hf.KERNELS + convolve.KERNELS + polyphase.KERNELS + demod.KERNELS
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
    return launches


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
# Phase 23: timing of the offline FDL's kernel
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


def fdl_bound(roof, streams: int, nb: int, m: int, partitions: int, shared: bool):
    """The partitioned accumulate's bound: X and H read once, Y written
    once (two float32 planes each); 8 operations a slot for each
    block-partition product."""
    planes = 2 * 4 * streams * nb * m
    filt = 2 * 4 * (1 if shared else streams) * partitions * m
    products = streams * sum(min(partitions, b + 1) for b in range(nb))
    return roof.roofline(2 * planes + filt, 8 * products * m)


def phase23(_cuda, convolve, roof, lib_path, dev, card) -> tuple[dict, object]:
    """``convolve_accumulate_partitioned`` (one launch of
    ``csrc/partitioned_accumulate.cu``), informational: ptxas's registers
    of each sub-ring count, and at each shape of FDL_SHAPES the kernel's
    geometry and time beside its plain version's and its bound. Returns
    the times at the reverb's shape and their bound."""
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

        t = kernel_times(kernel, plain, args, bound=rms_share(SUM_ORDER_GAP))
        groups, run = convolve.partitioned_geometry(streams, nb, m, partitions)
        log(f"phase 23 {k.name} {what} ({streams} x {nb} x {m}, P={partitions}, {'shared' if shared else 'per-stream'} "
            f"filter; {groups} sub-rings, runs of {run} blocks): max |kernel - plain| {t['max_abs_err']:.3e}; kernel "
            f"{t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, bound {bound.ms:.4f} ms "
            f"({bound.bound_by}; "
            f"{100 * bound.ms / t['device_ms']:.1f}% of it) [{card}]")
        if i == 0:
            times, reverb_bound = t, bound
        del xs, h, args
    torch.cuda.empty_cache()
    return times, reverb_bound


# ---------------------------------------------------------------------------
# Phase 24: timing of the polyphase decimator
# ---------------------------------------------------------------------------

# (rows, T, factor, taps, layout, what): config 5's two decimators on
# contiguous rows and as the chain lays them out (the front end's I/Q
# interleaved in the capture, the audio filter's input channel-fastest).
DECIM_SHAPES = (
    (2, 1 << 24, 2, 64, "rows", "config 5's front end, I and Q planes"),
    (2, 1 << 24, 2, 64, "interleaved", "config 5's front end, the interleaved capture"),
    (256, 32768, 4, 64, "rows", "config 5's audio filter, contiguous rows"),
    (256, 32768, 4, 64, "channels", "config 5's audio filter, channel-fastest"),
)


def decim_rows(rows: int, t: int, layout: str, dev, g) -> torch.Tensor:
    """(rows, T) float32 rows laid out as ``layout`` says: contiguous, the
    two planes of an interleaved complex64 capture, or channel-fastest (a
    (T, rows) tensor, transposed)."""
    if layout == "rows":
        return torch.randn(rows, t, device=dev, generator=g)
    if layout == "interleaved":
        return torch.view_as_real(torch.randn(t, dtype=torch.complex64, device=dev, generator=g)).T
    return torch.randn(t, rows, device=dev, generator=g).T


def decim_bound(roof, rows: int, t: int, factor: int, taps: int):
    """The decimator's bound: x and the taps read once, y written once;
    one FMA (2 operations) a tap for each kept output."""
    m = t // factor
    return roof.roofline(4 * (rows * t + rows * m + taps), 2 * rows * m * taps)


def phase24(_cuda, polyphase, roof, lib, lib_path, dev, card) -> tuple[dict, object]:
    """``polyphase.decimate_kernel`` (one launch of ``csrc/polyphase.cu``):
    the library's limits against Python's; then (informational) ptxas's
    registers and, at the chain's shapes, the kernel's geometry and time
    beside its plain version's, cuDNN's ``conv1d`` on the unframed rows
    and the bound. Returns the times at the front end's shape as the
    chain reads it and their bound."""
    import torch.nn.functional as F

    k = polyphase.DECIMATE
    limits = (lib.hopper_decimate_max_taps(), lib.hopper_decimate_max_factor())
    require(limits == (_cuda.MAX_DECIM_TAPS, _cuda.MAX_DECIM_FACTOR),
            f"decimator limits {limits} differ from Python's")
    for line in _cuda.kernel_resources(lib_path, k.name):
        log(f"phase 24 ptxas {k.name}: {line}")
    g = torch.Generator(device=dev)
    g.manual_seed(20261019)

    times = front_bound = None
    for rows, t, factor, taps, layout, what in DECIM_SHAPES:
        args = [(decim_rows(rows, t, layout, dev, g),) for _ in range(2)]
        h = torch.randn(taps, device=dev, generator=g) / taps**0.5
        flipped = torch.flip(h, (-1,))[None, None, :]
        bound = decim_bound(roof, rows, t, factor, taps)

        def cudnn(x):
            with polyphase.fp32_convolutions():
                return F.conv1d(F.pad(x, (taps - 1, 0))[:, None, :], flipped, stride=factor)[:, 0, : t // factor]

        tm = kernel_times(lambda x: polyphase.decimate_kernel(x, h, factor),
                          lambda x: polyphase.decimate_plain(x, h, factor), args, cudnn,
                          bound=rms_share(SUM_ORDER_GAP))
        threads, rb, q, smem = polyphase.decimate_geometry(factor, taps, args[0][0].stride(-1) == 1, rows)
        log(f"phase 24 {k.name} {what} ({rows} x {t}, strides {tuple(args[0][0].stride())}, f={factor}, {taps} taps; "
            f"{threads} threads, {rb} rows a block, {q} taps a phase, {smem} B): max |kernel - plain| "
            f"{tm['max_abs_err']:.3e}; kernel {tm['ms']:.4f} ms (device {tm['device_ms']:.4f} ms), plain {tm['plain_ms']:.4f} ms, library (cuDNN conv1d, unframed) "
            f"{tm['library_ms']:.4f} ms (device {tm['library_device_ms']:.4f} ms), bound {bound.ms:.4f} ms "
            f"({bound.bound_by}; {100 * bound.ms / tm['device_ms']:.1f}% of it, a gap of "
            f"{tm['device_ms'] / bound.ms:.2f}x) [{card}]")
        if layout == "interleaved":
            times, front_bound = tm, bound
        del args, h
    torch.cuda.empty_cache()
    return times, front_bound


# ---------------------------------------------------------------------------
# Phase 25: timing of the FM discriminator
# ---------------------------------------------------------------------------

DEMOD_GAP = 5e-7  # the discriminator's bound, absolute at gain 1: 2 ulp of pi
# (rows, T, layout, what): config 5's discriminator as the channelizer
# hands it its input, and on contiguous rows.
DEMOD_SHAPES = (
    (256, 32768, "channels", "config 5's discriminator, channel-fastest"),
    (256, 32768, "rows", "config 5's width, contiguous rows"),
)


def demod_bound(roof, rows: int, t: int):
    """The discriminator's bound: z (8 bytes a sample) read once, y (4)
    written once; 8 operations a sample (``portbench/sdr_work.py``)."""
    return roof.roofline(12 * rows * t, 8 * rows * t)


def phase25(_cuda, demod, roof, lib_path, dev, card) -> tuple[dict, object]:
    """``demod.fm_demod_kernel`` (one launch of ``csrc/demod.cu``): ptxas's
    registers and spills (a spill fails); then (informational) at the
    chain's width, the kernel's layout and time beside its plain
    version's and its bound. Returns the times at the chain's layout and
    their bound."""
    k = demod.FM_DEMOD
    lines = _cuda.kernel_resources(lib_path, k.name)
    require(bool(lines), f"no ptxas report of {k.name}")
    for line in lines:
        log(f"phase 25 ptxas {k.name}: {line}")
        spills = re.findall(r"(\d+) bytes spill", line)
        require(all(v == "0" for v in spills), f"{k.name} spills: {line}")
    g = torch.Generator(device=dev)
    g.manual_seed(20261021)

    def plain(z):  # the torch ops, their sample 0 set to the kernel's 0
        y = demod.fm_demod_plain(z)
        y[..., 0] = 0
        return y

    times = chain_bound = None
    for rows, t, layout, what in DEMOD_SHAPES:
        shape = (t, rows) if layout == "channels" else (rows, t)
        args = [(torch.randn(*shape, dtype=torch.complex64, device=dev, generator=g),) for _ in range(2)]
        if layout == "channels":
            args = [(z.T,) for (z,) in args]
        z = args[0][0]
        bound = demod_bound(roof, rows, t)
        tm = kernel_times(demod.fm_demod_kernel, plain, args, bound=lambda rms: DEMOD_GAP)
        which = demod.demod_layout(rows, z.stride(-2), z.stride(-1))
        log(f"phase 25 {k.name} {what} ({rows} x {t}, strides {tuple(z.stride())}; layout "
            f"{'rows-fast' if which == demod.ROWS_FAST else 'time-fast'}): max |kernel - plain| "
            f"{tm['max_abs_err']:.3e}; kernel {tm['ms']:.4f} ms (device {tm['device_ms']:.4f} ms), plain "
            f"{tm['plain_ms']:.4f} ms, bound {bound.ms:.4f} ms ({bound.bound_by}; {100 * bound.ms / tm['device_ms']:.1f}% "
            f"of it, a gap of {tm['device_ms'] / bound.ms:.2f}x) [{card}]")
        if layout == "channels":
            times, chain_bound = tm, bound
        del args, z
    torch.cuda.empty_cache()
    return times, chain_bound


# ---------------------------------------------------------------------------
# Phase 26: timing of the packed product
# ---------------------------------------------------------------------------

# (streams, frames, slots, filter, accumulate, what): the long-IR cell's
# per-channel product (N = 2^19, a filter per stream over 2 frames), a
# filter shared by every frame, and the per-stream product with an
# accumulator (``PartitionedFIR.step_k``'s form).
PRODUCT_SHAPES = (
    (64, 2, 1 << 18, "per-stream", False, "the long-IR cell's per-channel product"),
    (64, 2, 1 << 18, "shared", False, "a shared filter"),
    (64, 2, 1 << 18, "per-stream", True, "per-stream, accumulated"),
)


def product_bound(roof, streams: int, frames: int, m: int, filt: str, accumulate: bool):
    """The packed product's bound: a (and the accumulator) read once, the
    filter read once, y written once, 8 bytes a slot of each; 8 operations
    a slot (4 products, a sum, a difference, the scale), 2 more with the
    accumulator."""
    slots = streams * frames * m
    filter_rows = streams if filt == "per-stream" else 1
    return roof.roofline(8 * (slots * (2 + accumulate) + filter_rows * m), (8 + 2 * accumulate) * slots)


def phase26(_cuda, convolve, roof, lib_path, dev, card) -> tuple[dict, object]:
    """``convolve.packed_product_kernel`` (one launch of
    ``csrc/packed_product.cu``): ptxas's registers and spills (a spill
    fails); then at each shape of PRODUCT_SHAPES the kernel held to its
    plain version bit for bit, and (informational) its width, frames a
    unit and grid, and its time beside the plain version's and its bound.
    Returns the times at the long-IR shape and their bound."""
    k = convolve.PACKED_PRODUCT
    lines = _cuda.kernel_resources(lib_path, k.name)
    require(bool(lines), f"no ptxas report of {k.name}")
    for line in lines:
        log(f"phase 26 ptxas {k.name}: {line}")
        spills = re.findall(r"(\d+) bytes spill", line)
        require(all(v == "0" for v in spills), f"{k.name} spills: {line}")
    g = torch.Generator(device=dev)
    g.manual_seed(20261025)

    def planes(*shape):
        return tuple(torch.randn(*shape, device=dev, generator=g) for _ in range(2))

    times = long_ir_bound = None
    for i, (streams, frames, m, filt, accumulate, what) in enumerate(PRODUCT_SHAPES):
        h = planes(streams, 1, m) if filt == "per-stream" else planes(m)
        ab = planes(streams, frames, m) if accumulate else None
        args = [planes(streams, frames, m) for _ in range(2)]
        scale = 1.0 / (2 * m)
        bound = product_bound(roof, streams, frames, m, filt, accumulate)

        def kernel(xr, xi):
            return convolve.packed_product_kernel((xr, xi), h, ab, scale)

        def plain(xr, xi):
            return convolve.convolve_accumulate_packed_plain((xr, xi), h, ab, scale)

        t = kernel_times(kernel, plain, args, bound=lambda rms: 0.0)
        ops, outer, inner = convolve.product_operands(torch.Size((streams, frames, m)), args[0], h, ab)
        width = convolve.product_width(m, ops)
        unit_frames, blocks = convolve.product_geometry(outer, inner, m // width)
        log(f"phase 26 {k.name} {what} ({streams} x {frames} x {m}, {filt} filter"
            f"{', accumulated' if accumulate else ''}; {width} slots and {unit_frames} frames a unit, {blocks} "
            f"blocks): bit for bit the plain version; kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms), "
            f"plain {t['plain_ms']:.4f} ms, bound {bound.ms:.4f} ms ({bound.bound_by}; "
            f"{100 * bound.ms / t['device_ms']:.1f}% of it) [{card}]")
        if i == 0:
            times, long_ir_bound = t, bound
        del args, h, ab
    torch.cuda.empty_cache()
    return times, long_ir_bound


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    import chowdsp_fft_tpu_torch as ct
    from chowdsp_fft_tpu_torch import models, stream
    from chowdsp_fft_tpu_torch.ops import _cuda, convolve, demod, hopper_cfft, hopper_small, polyphase, row_passes
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

    # -- phase 3 ------------------------------------------------------------
    s, t, taps = CONFIG3["streams"], CONFIG3["samples"], CONFIG3["taps"]
    x64 = rng.standard_normal((s, t))
    h64 = rng.standard_normal(taps) / np.sqrt(taps)
    x = torch.from_numpy(x64.astype(np.float32)).to(dev)
    h = torch.from_numpy(h64.astype(np.float32)).to(dev)
    hf.reset_launch_counts()
    convolve.PARTITIONED.launches = convolve.PACKED_PRODUCT.launches = 0
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
    step_k_products = convolve.PACKED_PRODUCT.launches
    log(f"phase 3 step_k x{chunks} (K={k_blocks}) vs offline: max abs err {err:.3e}; packed product launches "
        f"{step_k_products}")
    require(err <= 1e-5, f"step_k streaming disagrees with offline: {err}")
    log("phase 3 ok")

    # -- phase 4 ------------------------------------------------------------
    for k in (hf.K1, hf.K2, hf.K3, convolve.PARTITIONED):
        require(launches[k.name] > 0, f"{k.name} was not launched on the main path")
    require(step_k_products > 0, f"{convolve.PACKED_PRODUCT.name} was not launched by step_k")
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
                                 lambda a: hf.rfft_packed_plain(a, plan, False), xs, lambda a: torch.fft.rfft(a),
                                 bound=held(n)),
        hf.K2.name: kernel_times(lambda r, i: hf.irfft_packed_kernel(r, i, plan, False),
                                 lambda r, i: hf.irfft_packed_plain(r, i, plan, False), specs,
                                 lambda c: torch.fft.irfft(c, n=n, norm="forward"), cspecs,
                                 bound=held(n, scale=1 / n)),
        hf.K3.name: kernel_times(lambda r, i: hf.convolve_irfft_packed_kernel(r, i, *filt, 1.0 / n, plan, False),
                                 lambda r, i: hf.convolve_irfft_packed_plain(r, i, *filt, 1.0 / n, plan, False),
                                 specs, bound=held(n)),
    }
    del xs, specs, cspecs
    for name, t in times.items():
        log_times(5, name, f"N={n} B={rows} unordered", t, card)
    g = row_passes.launch_geometry(plan, rows)
    for which, k in enumerate((hf.K1, hf.K2, hf.K3), start=1):
        log(f"phase 5 {k.name} geometry: {g.passes}, {g.rows_per_block} rows and {g.threads} threads a block, "
            f"{g.smem_bytes} B; {lib.hopper_real_fft_blocks_per_sm(which, g.threads, g.smem_bytes)} resident "
            f"blocks per SM")

    # -- phases 7-9: the paths, each read just after it runs -------------------
    capture = make_capture(rng)
    path5 = phase7(hf, models, stream, dev, capture)
    launches.update({k: v for k, v in path5.items()
                     if k in (hopper_small.K5_COMPLEX.name, polyphase.DECIMATE.name, demod.FM_DEMOD.name)})
    path4 = phase8(hf, stream, dev, capture)
    launches[hopper_cfft.K4.name] = path4[hopper_cfft.K4.name]
    path_r = phase9(hf, stream, dev, x, h, ref)
    for k in (hopper_small.K5_REAL, hopper_small.K5_REAL_INVERSE):
        launches[k.name] = path_r[k.name]

    # -- phases 13-14: config 2's top row, the reverb -------------------------
    path2 = phase13(ct, hc, hf, dev)
    for k in hc.KERNELS:
        launches[k.name] = path2[k.name]
    audio, ir = make_reverb(rng)
    launches[convolve.PACKED_PRODUCT.name] = phase14(ct, hc, hf, convolve, stream, dev, audio, ir)[
        convolve.PACKED_PRODUCT.name]

    # -- phases 16-18: config 4, the STFT, the pipelined kernels -------------
    path4c, model_calls = phase16(models, hf, convolve, dev, audio, ir)
    launches[convolve.PARTITIONED.name] += path4c[convolve.PARTITIONED.name]
    phase17(stream, hf, dev, audio)
    launches.update(phase18(ct, hf, hopper_cfft, lib, dev, rng, model_calls))

    # -- phase 20: the training slice on the card -------------------------------
    backward = phase20_training(hf, stream, models, dev, rng, x, h, ref, audio, ir)
    log(f"phase 20 ok; backward launches {backward}")

    # -- phase 21: the parallel layer on a one-rank NCCL group -----------------
    parallel_launches = phase21(hf, hopper_small, convolve, models, dev, x, h, ref, audio, ir, capture)
    del capture

    # -- phase 22: the last modules (planner, plans, merge, adapters, profiling) --
    adapter_launches = phase22(ct, hf, hopper_small, hc, stream, models, dev, card, times[hf.K1.name]["device_ms"],
                               audio, ir)

    # -- phases 23-26: the four kernels that replace no Pallas kernel ----------
    times[convolve.PARTITIONED.name], fdl_roof = phase23(_cuda, convolve, roof, lib_path, dev, card)
    times[polyphase.DECIMATE.name], decim_roof = phase24(_cuda, polyphase, roof, lib, lib_path, dev, card)
    times[demod.FM_DEMOD.name], demod_roof = phase25(_cuda, demod, roof, lib_path, dev, card)
    times[convolve.PACKED_PRODUCT.name], product_roof = phase26(_cuda, convolve, roof, lib_path, dev, card)

    # -- phase 10 -------------------------------------------------------------
    for k in hf.KERNELS + convolve.KERNELS + polyphase.KERNELS + demod.KERNELS:
        require(launches[k.name] > 0, f"{k.name} was not launched on its path")
    for n, kind in ((256, "complex"), (1024, "complex"), (4096, "complex"), (hf.MAX_CN, "complex"),
                    (8, "complex"), (480, "complex"), (256, "real"), (32, "real"), (16384, "complex"),
                    (1 << 19, "real"), (1 << 20, "real"), (1 << 20, "complex")):
        require(ct.engine_for(n, kind) == "hopper", f"engine_for({n}, {kind}) = {ct.engine_for(n, kind)}")
    for n, kind in ((6, "real"), (576, "real"), (1458, "real")):
        require(ct.engine_for(n, kind) == "stockham", f"engine_for({n}, {kind}) = {ct.engine_for(n, kind)}")
    log(f"phase 10 ok: every kernel carried its path; launches {launches}")

    # -- phases 11, 15 and 19: timing --------------------------------------------
    times.update(phase11(ct, hopper_cfft, hopper_small, row_passes, lib, dev, card))
    times.update(phase15(ct, hc, roof, lib, dev, card))
    times.update(phase19(ct, hf, hopper_cfft, roof, row_passes, lib, dev, card, audio.shape, model_calls))
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
    bounds[demod.FM_DEMOD.name] = demod_roof
    bounds[convolve.PACKED_PRODUCT.name] = product_roof
    direct = roof.direct_dft_roofline(*SMALL_TIMED, "complex")
    k5 = times[hopper_small.K5_COMPLEX.name]
    log(f"K5 complex at N={SMALL_TIMED[0]}, B={SMALL_TIMED[1]}: the direct DFT of the old design did "
        f"{direct.flops / 1e9:.1f} GFLOP, bound at {direct.ms:.4f} ms ({direct.bound_by}); the FFT now takes "
        f"{k5['device_ms']:.4f} ms on the device ({k5['ms']:.4f} ms a call), against the function's bound "
        f"{bounds[hopper_small.K5_COMPLEX.name].ms:.4f} ms ({bounds[hopper_small.K5_COMPLEX.name].bound_by}) [{card}]")

    kernels = []
    for k in hf.KERNELS + convolve.KERNELS + polyphase.KERNELS + demod.KERNELS:
        kernels.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "max_abs_err": times[k.name]["max_abs_err"],
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
