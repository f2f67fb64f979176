"""The compulsory-byte model reproduces the kernel bounds of PERF.md."""

import pytest

from benchmark import bytes as model

N_A, N_B = 10_000_000, 200_000_000


def test_k1_and_k4_bounds_at_the_upstream_shape():
    assert model.k1_bytes(N_A, N_B) == 840_000_000
    assert model.seconds_at_peak(model.k1_bytes(N_A, N_B)) * 1e3 == pytest.approx(0.2507, abs=1e-4)
    assert model.k4_bytes(N_A, N_B) == 2_480_000_000
    assert model.seconds_at_peak(model.k4_bytes(N_A, N_B)) * 1e3 == pytest.approx(0.7403, abs=1e-4)


def test_operation_and_phase_bytes():
    assert model.count_join_bytes(N_A, N_B) == 4 * (N_A + N_B)
    assert model.join_groupby_bytes(N_A, N_B) == 4 * (N_A + 2 * N_B)
    assert model.sort_phase_bytes(N_A, N_B) == 2 * 4 * (N_A + N_B)
    # half the least time is 50% of the roofline
    t = model.seconds_at_peak(model.k1_bytes(N_A, N_B))
    assert model.roofline_pct(model.k1_bytes(N_A, N_B), 2 * t) == pytest.approx(50.0)


def test_k3_bound_and_int64_bytes_at_the_upstream_shape():
    assert model.k3_bytes(N_A, N_B) == 1_680_000_000
    assert model.seconds_at_peak(model.k3_bytes(N_A, N_B)) * 1e3 == pytest.approx(0.5015, abs=1e-4)
    assert model.count_join_bytes(N_A, N_B, 8) == model.k3_bytes(N_A, N_B)
    assert model.join_groupby_bytes(N_A, N_B, 8) == 8 * (N_A + 2 * N_B)
    assert model.sort_phase_bytes(N_A, N_B, 8) == 2 * 8 * (N_A + N_B)
