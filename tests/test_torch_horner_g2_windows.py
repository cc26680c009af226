"""Kernel K4 over Fp2 on the CPU at the join's window edge cases (one
window, c = 1, c = 16): the second half of test_torch_horner_g2.py, a file
of its own so that a parallel run gives the two halves two workers (each
JAX G2 join traces and compiles for about a minute on a CPU).

Tolerance 0: exact integer arithmetic. Inputs from numpy seeds.
"""

import pytest

from test_torch_horner import check_edge_case
from test_torch_horner_g2 import _cpu_device, WINDOW_CASES  # noqa: F401


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_horner_join_g2_edge_cases_match_jax(case):
    check_edge_case("g2", case)
