import pytest

from portbench import roofline


def test_schur_operations_by_hand():
    # m = 2, n = 3: panels C W, A_1 W, A_2 W: 3 products of 3 x 3 by 3 x 3,
    # 2 * 27 operations each; the extended Gram matrix's triangle: 6 dot
    # products of length 9, 2 * 9 operations each.
    assert roofline.schur_ops(1, 2, 3) == 3 * 54 + 6 * 18
    assert roofline.schur_ops(5, 2, 3) == 5 * (3 * 54 + 6 * 18)
    # The cells' shapes (PERF.md): 3.05e8 and 1.2e10 per program.
    assert roofline.schur_ops(1, 100, 100) == 305_020_000
    assert roofline.schur_ops(1, 1000, 100) == 12_032_020_000


def test_schur_bytes_by_hand():
    # A (2 of 3 x 3), W and C per cone; G (2 x 2), AW, AQc (2 each),
    # w_dot_c, c_dot_Qc per program, 8 bytes each.
    assert roofline.schur_bytes(1, 1, 2, 3, 8) == 8 * (4 * 9 + 4 + 2 + 2 + 2)


def test_bound_names_what_wins():
    kind = "NVIDIA H100 80GB HBM3"
    seconds, by = roofline.bound_s(67e12, 1, kind, "float64")
    assert (seconds, by) == (pytest.approx(1.0), "operations")
    seconds, by = roofline.bound_s(1, 3.35e12, kind, "float64")
    assert (seconds, by) == (pytest.approx(1.0), "bytes")
    assert roofline.bound_s(1, 1, "some other card", "float64") is None
