"""The work of one call of the SDR receiver chain (BASELINE config 5),
for its roofline (``roofline.least_seconds``): what the chain must do
to a capture, whatever kernels do it.

Bytes: the complex64 capture read once (8 T) and the float32 audio
written once (4 C S / A). Operations, with S = T / (D C) channel steps:

- the front end: 2 planes x T / D outputs x 2 a tap;
- the branch FIR: 2 planes x C branches x S steps x 2 a tap, K taps;
- the channel FFT: S transforms of C points at 5 C log2 C;
- the discriminator: 8 a channel sample;
- the audio decimator: C x S / A outputs x 2 a tap.
"""

from __future__ import annotations

import math


def chain_work(samples: int, channels: int, decimation: int, front_taps: int, taps_per_branch: int,
               audio_decimation: int, audio_taps: int) -> tuple[float, float]:
    """(bytes, operations) of the chain on one capture of ``samples``."""
    steps = samples // (decimation * channels)
    audio = channels * (steps // audio_decimation)
    bytes_moved = 8 * samples + 4 * audio
    front = 2 * (samples // decimation) * 2 * front_taps
    branch = 2 * channels * steps * 2 * taps_per_branch
    fft = steps * 5 * channels * math.log2(channels)
    demod = 8 * channels * steps
    audio_fir = audio * 2 * audio_taps
    return float(bytes_moved), float(front + branch + fft + demod + audio_fir)
