"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
700 W limit), and the least time a piece of work could take on it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}


def bound_s(nbytes: float, ops: float = 0.0, kind: str = "int8") -> float:
    """The larger of the bytes over the HBM rate and the operations over
    the peak rate of their type."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def roofline_pct(bound_seconds: float, device_seconds: float) -> float | None:
    """Share of the device time that the least time for the work takes, in
    %; None where the kernel did not run."""
    if device_seconds <= 0:
        return None
    return 100.0 * bound_seconds / device_seconds
