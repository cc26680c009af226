"""`scalar_mul_digits` of the port (the digit ladder's table and rounds on
their twins) against the JAX package's, in affine form, and the ladder's
program on the port's table: G1 at c = 8 and G2 at c = 1, 4 and 8 (4 and 8
`slow`: each JAX G2 ladder compiles ~2 min). The second half of
test_torch_ladder.py's JAX comparisons, a file of its own so that a
parallel run gives the two halves two workers.

Tolerance 0: exact integer arithmetic. Inputs from numpy seeds.
"""

import pytest

from test_torch_ladder import _cpu_device, check_scalar_mul_digits  # noqa: F401


@pytest.mark.parametrize("group,c", [
    ("g1", 8), ("g2", 1),
    pytest.param("g2", 4, marks=pytest.mark.slow), pytest.param("g2", 8, marks=pytest.mark.slow),
])
def test_scalar_mul_digits_matches_jax(group, c):
    check_scalar_mul_digits(group, c)
