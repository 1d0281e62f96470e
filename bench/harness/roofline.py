"""The H100's published peaks and the kernels' bytes and operations.

Copied from `chip_smoke.py` (`F32_PEAK`, `INT8_PEAK`, `HBM_RATE`,
`bound_ms`, and the bytes and operations `_maxmin_at_dag` counts for
`fill_maxmin`), so that the yardstick lives with the benchmark.  Peaks are
NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense rates.
"""
from __future__ import annotations

F32_PEAK = 67e12        # float32 FLOP/s outside the tensor cores
INT8_PEAK = 1979e12     # int8 tensor-core OP/s, dense
HBM_RATE = 3.35e12      # HBM3 bytes/s


def bound_s(bytes_moved: float, ops: float, rate: float = F32_PEAK
            ) -> tuple[float, str]:
    """The least time for the work: the bytes at the HBM rate or the
    operations at `rate`, whichever is longer, and which of the two."""
    t_bytes, t_ops = bytes_moved / HBM_RATE, ops / rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def fill_maxmin_bytes(s: int, n: int, c: int, e: int, m: int = 1) -> float:
    """One `fill_maxmin` launch of S lanes over M problems' CSR (N tasks,
    C constraints, E entries), each byte once: the CSR (con_ptr, ent_task,
    ent_w) and flows per problem, active (1 byte) and caps per lane read,
    rates and rounds per lane written."""
    return (m * (4.0 * (c + 1) + 8.0 * e + 4.0 * n)
            + s * n + 4.0 * s * c + 4.0 * s * n + 4.0 * s)


def fill_maxmin_ops(rounds: int, n: int, c: int, e: int) -> float:
    """Operations of a launch whose lanes ran `rounds` filling rounds in
    all: per lane and round two FMAs per entry, a subtraction, a division
    and a min per constraint, an add per task."""
    return rounds * (4.0 * e + 3.0 * c + n)
