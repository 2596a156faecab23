"""The wideband SDR receiver chain (BASELINE config 5) in float64, from
the definitions, one stage a function:

- the decimating FIR with zero state, y[m] = sum_k h[k] x[m D - k], for
  the first T // D outputs (the front end, and the audio decimator);
- the analysis filter bank: channel c at step m is the stream mixed down
  by e^{-2 pi i c n / C}, low-passed by the prototype and kept at sample
  m C + C - 1, times e^{2 pi i c (C - 1) / C} / C. Written out, that is
  (1/C) sum_j proto[j] e^{2 pi i c j / C} z[m C + C - 1 - j], one matrix
  product of the framed windows with the (taps, C) matrix, a block of
  steps at a time;
- the FM discriminator, y[n] = angle(z[n] conj(z[n - 1])), y[0] = 0.

The filters come from their definition (:func:`filters`), the
windowed-sinc low-pass under a Hamming window at unit gain at DC: the
front end's and the audio decimator's taps, and the channelizer's
prototype in natural order. The stages take any taps, as float64.
Leading dimensions of the capture are carried through.
"""

from __future__ import annotations

import math

import torch

# float64 takes no TF32 path; the flags are cleared all the same, so that
# nothing computed beside the reference in this process takes one unasked.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEPS_PER_BLOCK = 4096


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.complex128) if x.is_complex() else x.to(torch.float64)


def lowpass(taps: int, cutoff: float, device=None) -> torch.Tensor:
    """float64 (taps,): cutoff sinc(cutoff (n - (taps - 1) / 2)) times the
    Hamming window 0.54 - 0.46 cos(2 pi n / (taps - 1)), scaled to sum 1;
    ``cutoff`` is a share of the Nyquist rate."""
    n = torch.arange(taps, dtype=torch.float64, device=device)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n / (taps - 1))
    h = cutoff * torch.sinc(cutoff * (n - (taps - 1) / 2)) * window
    return h / h.sum()


def filters(channels: int, decimation: int, front_taps: int, taps_per_branch: int, audio_decimation: int,
            audio_taps: int, device=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain's three filters: the front end's (cutoff 1/D), the audio
    decimator's (1/A) and the channelizer's prototype of C K taps (1/C),
    in natural order."""
    return (lowpass(front_taps, 1.0 / decimation, device), lowpass(audio_taps, 1.0 / audio_decimation, device),
            lowpass(channels * taps_per_branch, 1.0 / channels, device))


def decimate(x: torch.Tensor, h: torch.Tensor, factor: int) -> torch.Tensor:
    """y[m] = sum_k h[k] x[m factor - k] (x[n] = 0 for n < 0), for
    m < T // factor: float64 or complex128 (..., T // factor)."""
    x, h = _wide(x), h.to(torch.float64)
    taps, outputs = h.shape[-1], x.shape[-1] // factor
    padded = torch.cat([torch.zeros(*x.shape[:-1], taps - 1, dtype=x.dtype, device=x.device), x], dim=-1)
    y = torch.zeros(*x.shape[:-1], outputs, dtype=x.dtype, device=x.device)
    for k in range(taps):
        start = taps - 1 - k  # x[m factor - k] sits at padded[m factor + taps - 1 - k]
        y += h[k] * padded[..., start: start + factor * (outputs - 1) + 1: factor]
    return y


def bank_matrix(proto: torch.Tensor, channels: int) -> torch.Tensor:
    """(taps, C) complex128: proto[j] e^{2 pi i c j / C} / C, with the
    exponent reduced to (c j mod C) in integers."""
    taps = proto.shape[-1]
    j = torch.arange(taps, device=proto.device)
    c = torch.arange(channels, device=proto.device)
    turns = (j[:, None] * c[None, :]) % channels
    angle = turns.to(torch.float64) * (2 * math.pi / channels)
    return proto.to(torch.float64)[:, None] * torch.polar(torch.ones_like(angle), angle) / channels


def channelize(z: torch.Tensor, proto: torch.Tensor, channels: int) -> torch.Tensor:
    """(..., T) -> complex128 (..., C, T // C): channel c at step m is
    (1/C) sum_j proto[j] e^{2 pi i c j / C} z[m C + C - 1 - j], with
    z[n] = 0 for n < 0."""
    z = z.to(torch.complex128)
    taps, steps = proto.shape[-1], z.shape[-1] // channels
    # Window m is padded[m C : m C + taps] reversed: padded[m C + i] is
    # z[m C + i - (taps - C)], and i = taps - 1 - j.
    padded = torch.cat([torch.zeros(*z.shape[:-1], taps - channels, dtype=z.dtype, device=z.device),
                        z[..., : steps * channels]], dim=-1)
    reversed_bank = torch.flip(bank_matrix(proto, channels), (0,))
    out = torch.empty(*z.shape[:-1], steps, channels, dtype=z.dtype, device=z.device)
    for s0 in range(0, steps, STEPS_PER_BLOCK):
        s1 = min(steps, s0 + STEPS_PER_BLOCK)
        windows = padded[..., s0 * channels: (s1 - 1) * channels + taps].unfold(-1, taps, channels)
        out[..., s0:s1, :] = windows @ reversed_bank
    return out.transpose(-1, -2)


def discriminate(z: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """gain * angle(z[n] conj(z[n - 1])) along the last axis, 0 at n = 0:
    float64."""
    z = z.to(torch.complex128)
    step = torch.angle(z[..., 1:] * torch.conj(z[..., :-1]))
    return gain * torch.cat([torch.zeros_like(step[..., :1]), step], dim=-1)


def channel_streams(iq: torch.Tensor, front_lp: torch.Tensor, proto: torch.Tensor, channels: int,
                    decimation: int) -> torch.Tensor:
    """The front end then the filter bank: complex128 (..., C, T // (D C))."""
    return channelize(decimate(iq, front_lp, decimation), proto, channels)


def audio(streams: torch.Tensor, audio_lp: torch.Tensor, audio_decimation: int, gain: float = 1.0) -> torch.Tensor:
    """The discriminator then the audio decimator: float64 (..., C, S // A)."""
    return decimate(discriminate(streams, gain), audio_lp, audio_decimation)


def chain(iq: torch.Tensor, front_lp: torch.Tensor, audio_lp: torch.Tensor, proto: torch.Tensor, channels: int,
          decimation: int, audio_decimation: int, gain: float = 1.0) -> torch.Tensor:
    """(..., T) complex IQ -> float64 (..., C, T // (D C A)) audio."""
    return audio(channel_streams(iq, front_lp, proto, channels, decimation), audio_lp, audio_decimation, gain)
