"""The card's peaks and a kernel's least time, copied from the port's
smoke script (`chip_smoke.py`: `bound`, `HBM_BYTES_PER_S`,
`F32_OPS_PER_S`) so that the yardstick does not move with the program.

Peaks are NVIDIA's data sheet figures for one H100 SXM at its full power
limit of 700 W: 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the
tensor cores.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "bound_s"]

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card could
    take for work that moves n_bytes once and does n_ops float32
    operations (a multiply-add counts 2), the larger of the two."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
