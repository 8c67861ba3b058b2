"""Rounding to a narrower float format, for the controls."""

from __future__ import annotations

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away from
    zero, as the card converts), returned as float32."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)
