"""Compulsory bytes of the benchmark's operations and kernels, from shapes.

Every input column an operation needs is read once and every output column
written once, whatever the implementation reads again.  ``word`` is the bytes
of one column entry: 4 for int32 columns, 8 for int64.  A share of a roofline is these bytes over the H100 SXM's published
3.35 TB/s, divided by the measured time; it reads the same work whatever
implements it.  Counts that a multi-pass sort moves are not modelled: its
passes are the implementation's, and the share shows what they cost.
"""

from __future__ import annotations

#: The H100 SXM's HBM3 bandwidth, bytes/s (NVIDIA's data sheet, at 700 W).
HBM_PEAK_BYTES_PER_S = 3.35e12
#: Bytes of one int32 column entry.
WORD = 4


def count_join_bytes(n_a: int, n_b: int, word: int = WORD) -> int:
    """A count join: both key columns read once; the count is a scalar."""
    return word * (n_a + n_b)


def join_groupby_bytes(n_a: int, n_b: int, word: int = WORD) -> int:
    """JOIN → GROUP BY key → top k over b's payloads: the build keys, the
    probe keys and the probe payloads read once; k rows out."""
    return word * (n_a + 2 * n_b)


def sort_phase_bytes(n_a: int, n_b: int, word: int = WORD) -> int:
    """Both key columns sorted: each read once and written once."""
    return 2 * word * (n_a + n_b)


def k1_bytes(n_a: int, n_b: int) -> int:
    """K1, the merge count of two sorted int32 key runs: both read once."""
    return count_join_bytes(n_a, n_b, 4)


def k3_bytes(n_a: int, n_b: int) -> int:
    """K3, K1's int64 form: both sorted int64 key runs read once."""
    return count_join_bytes(n_a, n_b, 8)


def k4_bytes(n_a: int, n_b: int) -> int:
    """K4, the merge payload probe over int32 columns: build keys and
    payloads and probe keys read once, a payload and a position written per
    probe row."""
    return WORD * (2 * n_a + 3 * n_b)


def seconds_at_peak(n_bytes: int) -> float:
    return n_bytes / HBM_PEAK_BYTES_PER_S


def roofline_pct(n_bytes: int, seconds: float) -> float:
    """The least time ``n_bytes`` take at peak, as a share of ``seconds``."""
    return 100.0 * seconds_at_peak(n_bytes) / seconds
