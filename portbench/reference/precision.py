"""The control's precision: TF32, the step below float32 with TF32 off.

A TF32 operand keeps 10 of float32's 23 mantissa bits. Rounding each
input to TF32 and computing the rest exactly is the least error any TF32
path can have, so a limit that this control fails, every TF32 path
fails."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)
