"""The card's published peaks and the least time a pass could take.

NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at the full 700 W
power limit: 3.35 TB/s of HBM bandwidth, 67 TFLOP/s in float32 and 34
TFLOP/s in float64 outside the tensor cores. A roofline share is the least
time over the measured time; the least time is the larger of the bytes a
pass must move, each once, over the bandwidth and its operations over the
peak rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """Seconds: max(bytes / bandwidth, operations / peak rate)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
