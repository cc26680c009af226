"""Skewed G2 MSMs on the K3 route (the K3 twin at n = 96 with c = 10)
against the JAX package's native engine, in affine: all-equal scalars,
[R - 1] + [1] * (n - 1), and a batch whose weight sits in the top window.
The G2 K3-route cases of test_torch_bucket_split.py, a file of their own so
that a parallel run gives them a worker (~3 min of the plain twins).

Tolerance 0: exact integer arithmetic. Inputs from numpy seeds.
"""

import pytest

from test_torch_bucket_split import _cpu_device, PATTERNS, check_skewed_msm  # noqa: F401


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("group,route", [("g2", "k3-c10")])
def test_skewed_msm_matches_native(group, route, pattern):
    check_skewed_msm(group, route, pattern)
