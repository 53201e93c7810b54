"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W) and
the roofline arithmetic."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # outside the tensor cores
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
PEAK_OPS = {"float32": F32_OPS_PER_S, "tf32": TF32_OPS_PER_S,
            "bfloat16": BF16_OPS_PER_S}


def least_seconds(nbytes: float, ops: float = 0.0,
                  ops_per_s: float = F32_OPS_PER_S) -> float:
    """The least time the chip could take: bytes over the memory's rate
    or operations over the peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def share_pct(least_s: float, measured_s: float):
    """The least time as a share of the measured one, in %; None when
    nothing was measured."""
    if measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s


def mfu_pct(ops: float, seconds: float, ops_per_s: float):
    """Operations done over the time, as a share of the peak, in %."""
    if seconds <= 0:
        return None
    return 100.0 * ops / seconds / ops_per_s
