"""Overlap-save (OLS) FFT convolution: single-FFT and partitioned forms
(PyTorch counterpart of ``chowdsp_fft_tpu/stream/ols.py``).

Blocks are framed with static shapes and transformed as one batch; the
frequency-domain work uses the unordered packed transforms and the packed
convolve, so no reorder pass is ever paid. The partitioned form keeps a
frequency-domain delay line (FDL): offline, every partition is summed in
one partitioned accumulate; streaming, partition by partition with the
packed convolve-accumulate. Results land on the input's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import api
from ..ops.autodiff import PartitionedAccumulate
from ..utils.tracing import span, spanned

__all__ = [
    "next_fft_size",
    "fir_filter_ols",
    "PartitionedFIR",
    "partitioned_fir_apply",
]


def next_fft_size(n: int) -> int:
    """Smallest power-of-two FFT size >= n (keeps the stream layer on the
    kernel engine's sizes)."""
    p = 1
    while p < n:
        p <<= 1
    return p


@spanned("stream.ols.frame")
def _frame_overlap(x: torch.Tensor, block: int, overlap: int) -> torch.Tensor:
    """(..., T) -> (..., num_blocks, overlap + block) frames, stride =
    block, left-padded with `overlap` zeros (and right-padded to whole
    blocks). Built from whole-row reshapes, contiguous slices and one
    concat: frame i = rows[i] ++ rows[i+1][:rem] ..."""
    t = x.shape[-1]
    nblocks = -(-t // block)
    frame_len = overlap + block
    k = -(-frame_len // block)  # rows each frame spans
    target_len = (nblocks - 1 + k) * block  # whole rows, covers the last frame
    x = F.pad(x, (overlap, target_len - overlap - t))
    rows = x.reshape(*x.shape[:-1], nblocks - 1 + k, block)
    parts = []
    for j in range(k):
        take = min(block, frame_len - j * block)
        parts.append(rows[..., j : j + nblocks, :take])
    return torch.cat(parts, dim=-1)


def filter_device(h, device: torch.device | str | None = None) -> torch.device | str:
    """Where a filter built from ``h`` lives: ``device`` if given, else a
    tensor ``h``'s device, else the card."""
    if device is not None:
        return device
    return h.device if isinstance(h, torch.Tensor) else "cuda"


@spanned("stream.ols.fir_filter_ols")
def fir_filter_ols(
    x: torch.Tensor,
    h: torch.Tensor,
    block: int | None = None,
    engine: str = "auto",
) -> torch.Tensor:
    """Linear FIR filtering of (..., T) streams by (taps,) or broadcastable
    (..., taps) filters via single-partition overlap-save.

    Returns the same-length (truncated to T) filtered stream, matching
    scipy.signal.lfilter(h, 1, x) semantics (zero initial state). It runs
    on ``x``'s device (``h`` is moved there). The FFT size is the power of
    two >= block + taps - 1; long filters (a 2 s reverb IR at 48 kHz takes
    N = 2^19) run on the Hopper engine's two-level composite.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    taps = h.shape[-1]
    t = x.shape[-1]
    if block is None:
        block = max(256, next_fft_size(4 * taps) // 2)
    n = next_fft_size(block + taps - 1)
    block = n - (taps - 1)

    plan = api.cached_plan(n, api.FFT_REAL)
    hpad = F.pad(h, (0, n - taps))
    hre, him = api.rfft_packed_unordered(hpad, plan=plan, engine=engine)
    if h.ndim > 1:
        # Filters with batch dims broadcast against the stream's batch
        # dims, not the frames axis: insert the frames axis.
        hre, him = hre[..., None, :], him[..., None, :]

    frames = _frame_overlap(x, block, taps - 1)  # (..., nb, n)
    xre, xim = api.rfft_packed_unordered(frames, plan=plan, engine=engine)
    if h.ndim == 1:
        # Shared filter: the spectral product fuses into the inverse
        # kernel, so the product spectrum never reaches device memory.
        yblocks = api.convolve_irfft_packed(
            xre, xim, hre, him, scaling=1.0 / n, plan=plan, engine=engine,
            ordered=False,
        )
    else:
        yre, yim = api.convolve_accumulate_packed(
            (xre, xim), (hre, him), scaling=1.0 / n
        )
        yblocks = api.irfft_packed_unordered(yre, yim, plan=plan, engine=engine)
    # Overlap-save: the first taps-1 samples of each block are circularly
    # corrupted; keep the last `block` samples.
    with span("stream.ols.trim"):
        y = yblocks[..., taps - 1 :]
        y = y.reshape(*y.shape[:-2], -1)
    return y[..., :t]


class PartitionedFIR:
    """Uniformly partitioned overlap-save convolution (frequency-domain
    delay line). The impulse response is split into P partitions of
    `block` taps; each incoming block costs one rfft, P packed
    convolve-accumulates and one irfft.

    ``init_state()`` returns the state dict (keys ``fdl_re``, ``fdl_im``,
    ``prev``); ``step()`` maps (state, block) -> (new state, filtered
    block). Use :func:`partitioned_fir_apply` for whole (batched) streams.
    The filter and its state live on ``device``: by default a tensor
    ``h``'s own device, the card for anything else (a numpy array, a list).
    Input blocks are moved to the filter's device.
    """

    def __init__(self, h: torch.Tensor, block: int = 1024, engine: str = "auto",
                 device: torch.device | str | None = None):
        h = torch.as_tensor(h, dtype=torch.float32, device=filter_device(h, device))
        self._setup(block, engine, -(-h.shape[-1] // int(block)))
        taps = h.shape[-1]
        hpad = F.pad(h, (0, self.partitions * self.block - taps))
        hparts = hpad.reshape(*h.shape[:-1], self.partitions, self.block)
        hparts = F.pad(hparts, (0, self.n - self.block))
        # (..., P, N/2) packed-plane frequency-domain partitions.
        self.h_re, self.h_im = api.rfft_packed_unordered(
            hparts, plan=self.plan, engine=self.engine
        )

    def _setup(self, block: int, engine: str, partitions: int):
        self.block = int(block)
        self.n = 2 * self.block  # 50% overlap-save
        self.engine = engine
        self.plan = api.cached_plan(self.n, api.FFT_REAL)
        self.partitions = partitions

    @classmethod
    def from_spectra(
        cls, h_re: torch.Tensor, h_im: torch.Tensor, block: int, engine: str = "auto"
    ) -> "PartitionedFIR":
        """Build from (..., P, block) packed filter spectra that are already
        in the engine's unordered layout (see
        ``convert.partitioned_fir_from_numpy``). The filter keeps copies:
        the caller may refill its tensors afterwards."""
        return cls._on_spectra(h_re.to(torch.float32, copy=True), h_im.to(torch.float32, copy=True), block, engine)

    @classmethod
    def _on_spectra(cls, h_re: torch.Tensor, h_im: torch.Tensor, block: int, engine: str) -> "PartitionedFIR":
        """A filter that reads ``h_re``/``h_im`` in place (float32 spectra
        its owner keeps, as ``MultichannelConvolver``'s buffers)."""
        if h_re.shape != h_im.shape or h_re.shape[-1] != int(block):
            raise ValueError(
                f"spectra must be (..., P, {block}) planes, got {tuple(h_re.shape)} and {tuple(h_im.shape)}"
            )
        fir = cls.__new__(cls)
        fir._setup(block, engine, h_re.shape[-2])
        fir.h_re = h_re
        fir.h_im = h_im
        return fir

    def _on_device(self, x) -> torch.Tensor:
        """Input blocks go to the filter's device (as JAX puts them on its
        default device)."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.h_re.device)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> dict:
        m = self.n // 2
        dev = self.h_re.device
        return {
            "fdl_re": torch.zeros((*batch_shape, self.partitions, m), device=dev),
            "fdl_im": torch.zeros((*batch_shape, self.partitions, m), device=dev),
            "prev": torch.zeros((*batch_shape, self.block), device=dev),
        }

    def _filter(self, p: int, below_block_axis: bool):
        hr = self.h_re[..., p, :]
        hi = self.h_im[..., p, :]
        if below_block_axis and hr.ndim > 1:
            # per-stream filters broadcast below the block axis
            hr, hi = hr[..., None, :], hi[..., None, :]
        return hr, hi

    @spanned("stream.ols.apply_offline")
    def apply_offline(self, x: torch.Tensor) -> torch.Tensor:
        """Filter whole (..., T) streams: all block spectra from ONE batched
        rfft, the FDL as one causal accumulate of every partition along the
        block axis (``ops.convolve.convolve_accumulate_partitioned``, a
        kernel on the card; the same math as stepping :meth:`step` block by
        block)."""
        x = self._on_device(x)
        t = x.shape[-1]
        nb = -(-t // self.block)
        frames = _frame_overlap(x, self.block, self.block)[..., :nb, :]
        xre, xim = api.rfft_packed_unordered(frames, plan=self.plan, engine=self.engine)
        acc = PartitionedAccumulate.apply(xre, xim, self.h_re, self.h_im, 1.0 / self.n)
        yfull = api.irfft_packed_unordered(acc[0], acc[1], plan=self.plan, engine=self.engine)
        with span("stream.ols.trim"):
            y = yfull[..., self.block :].reshape(*x.shape[:-1], nb * self.block)
        return y[..., :t]

    @spanned("stream.ols.step_k")
    def step_k(self, state: dict, xk: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """Process K blocks at once: (..., K, block) -> (..., K, block).
        All K spectra come from one batched rfft and the FDL becomes K
        contiguous-slice accumulates against the carried spectrum history;
        the same math as K sequential :meth:`step` calls."""
        xk = self._on_device(xk)
        k = xk.shape[-2]
        # frame j = [block_{j-1} | block_j], with block_{-1} = prev
        with span("stream.ols.frame"):
            blocks_all = torch.cat([state["prev"][..., None, :], xk], dim=-2)
            frames = torch.cat([blocks_all[..., :-1, :], blocks_all[..., 1:, :]], dim=-1)
        xre, xim = api.rfft_packed_unordered(frames, plan=self.plan, engine=self.engine)
        # E rows: spectra of steps t-P .. t+K-1 (ascending)
        with span("stream.ols.fdl_shift"):
            e_re = torch.cat([torch.flip(state["fdl_re"], dims=[-2]), xre], dim=-2)
            e_im = torch.cat([torch.flip(state["fdl_im"], dims=[-2]), xim], dim=-2)
        p_total = self.partitions
        acc = None
        for p in range(p_total):
            acc = api.convolve_accumulate_packed(
                (
                    e_re[..., p_total - p : p_total - p + k, :],
                    e_im[..., p_total - p : p_total - p + k, :],
                ),
                self._filter(p, True),
                ab=acc,
                scaling=1.0 / self.n,
            )
        yfull = api.irfft_packed_unordered(acc[0], acc[1], plan=self.plan, engine=self.engine)
        with span("stream.ols.fdl_shift"):
            fdl_re = torch.flip(e_re[..., k : k + p_total, :], dims=[-2])
            fdl_im = torch.flip(e_im[..., k : k + p_total, :], dims=[-2])
        new_state = {
            "fdl_re": fdl_re,
            "fdl_im": fdl_im,
            "prev": xk[..., -1, :].clone(),  # a copy: the caller may refill xk
        }
        return new_state, yfull[..., self.block :]

    @spanned("stream.ols.step")
    def step(self, state: dict, xblock: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """Process one (..., block) input block -> (..., block) output.
        The caller's state is not modified: the new FDL is a rolled copy,
        into which the new spectrum is written in place."""
        xblock = self._on_device(xblock)
        with span("stream.ols.frame"):
            frame = torch.cat([state["prev"], xblock], dim=-1)  # (..., n)
        xre, xim = api.rfft_packed_unordered(frame, plan=self.plan, engine=self.engine)
        with span("stream.ols.fdl_shift"):
            fdl_re = torch.roll(state["fdl_re"], 1, dims=-2)
            fdl_im = torch.roll(state["fdl_im"], 1, dims=-2)
            fdl_re[..., 0, :] = xre
            fdl_im[..., 0, :] = xim
        # y = sum_p fdl[p] * h[p]: P packed convolve-accumulates.
        acc = None
        for p in range(self.partitions):
            acc = api.convolve_accumulate_packed(
                (fdl_re[..., p, :], fdl_im[..., p, :]),
                self._filter(p, False),
                ab=acc,
                scaling=1.0 / self.n,
            )
        yfull = api.irfft_packed_unordered(acc[0], acc[1], plan=self.plan, engine=self.engine)
        # prev is a copy: the caller may refill xblock before the next step.
        return {"fdl_re": fdl_re, "fdl_im": fdl_im, "prev": xblock.clone()}, yfull[..., self.block :]


def partitioned_fir_apply(
    x: torch.Tensor,
    h: torch.Tensor,
    block: int = 1024,
    engine: str = "auto",
    streaming: bool = False,
    chunk: int = 1,
) -> torch.Tensor:
    """Filter (..., T) streams with a long FIR `h` through the uniformly
    partitioned FDL. Returns (..., T) (zero-state, truncated).

    ``streaming=False`` (default): :meth:`PartitionedFIR.apply_offline`.
    ``streaming=True`` steps block by block through :meth:`~PartitionedFIR.step`
    (the real-time state semantics), or, with ``chunk=K``, K blocks at a
    time through :meth:`~PartitionedFIR.step_k`; the same math either way."""
    x = torch.as_tensor(x, dtype=torch.float32)
    fir = PartitionedFIR(torch.as_tensor(h, dtype=torch.float32, device=x.device), block=block, engine=engine)
    if not streaming:
        return fir.apply_offline(x)
    t = x.shape[-1]
    nb = -(-t // fir.block)
    k = max(1, min(chunk, nb))
    nchunks = -(-nb // k)
    xp = F.pad(x, (0, nchunks * k * fir.block - t))
    blocks = xp.reshape(*x.shape[:-1], nchunks, k, fir.block)
    state = fir.init_state(tuple(x.shape[:-1]))
    ys = []
    for c in range(nchunks):
        if k == 1:
            state, y = fir.step(state, blocks[..., c, 0, :])
        else:
            state, y = fir.step_k(state, blocks[..., c, :, :])
            y = y.reshape(*x.shape[:-1], k * fir.block)
        ys.append(y)
    return torch.cat(ys, dim=-1)[..., :t]
