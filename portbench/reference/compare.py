"""The comparison that decides ``correct``: the widest gap between an
output and its float64 reference, over the reference's rms."""

from __future__ import annotations

import torch


def gap(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / rms(ref), in float64."""
    ref = ref.double()
    diff = (out.double() - ref).abs().max()
    return float(diff / ref.square().mean().sqrt())
