"""The yardstick's peaks and the least time of each kernel, from its
shapes.  Frozen here so that no later change to the program moves them.

One NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def join_count_bound_ms(B: int, L: int, S: int) -> float:
    """Least time of one `join_count` call: read B*L probe keys and B*S
    build keys, write B*L `lo` and B*L counts, 4 bytes each, once, at the
    card's memory rate."""
    return B * (12 * L + 4 * S) / HBM_BYTES_PER_S * 1e3
