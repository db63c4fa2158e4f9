"""The NUFFT roofline's count against the bounds of the port's kernel
table (PERF.md, rows 4, 9 and 10)."""
import pytest

from benchmark import work


@pytest.mark.parametrize("kind, n, mtot, B, want", [
    (1, 10 ** 6, 339, 1, 5.6693),
    (1, 10 ** 6, 677, 1, 22.4165),
    (2, 10 ** 6, 339, 5, 28.1291),
    (1, 10 ** 6, 339, 5, 28.0785),
])
def test_least_ms_matches_the_kernel_table(kind, n, mtot, B, want):
    ms, bound = work.least_ms(kind, 2, n, mtot, B)
    assert round(ms, 4) == want
    assert bound == "operations"


def test_least_ms_is_bytes_bound_for_few_modes():
    assert work.least_ms(2, 2, 10 ** 6, 1, 1)[1] == "bytes"
