"""The port's numeric helpers (kzg_tpu_torch.utils) against the JAX
package's (kzg_tpu.utils), value for value and error for error."""

import pytest

from kzg_tpu import utils as jutils
from kzg_tpu_torch import utils

VALUES = [1, 2, 3, 4, 5, 7, 8, 9, 1023, 1024, 1025, (1 << 32) - 1, 1 << 32, (1 << 255) + 3]


@pytest.mark.parametrize("name", ["log2", "log2_ceil", "is_power_of_two", "next_power_of_two"])
@pytest.mark.parametrize("x", VALUES)
def test_int_helpers_match_jax(name, x):
    assert getattr(utils, name)(x) == getattr(jutils, name)(x)


@pytest.mark.parametrize("name", ["log2", "log2_ceil"])
@pytest.mark.parametrize("x", [0, -1])
def test_log2_refuses_what_jax_refuses(name, x):
    with pytest.raises(ValueError):
        getattr(jutils, name)(x)
    with pytest.raises(ValueError):
        getattr(utils, name)(x)


@pytest.mark.parametrize("x", [0, -4])
def test_non_positive_helpers_match_jax(x):
    assert utils.is_power_of_two(x) == jutils.is_power_of_two(x)
    assert utils.next_power_of_two(x) == jutils.next_power_of_two(x)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9, 100])
def test_pad_to_power_of_two_matches_jax(n):
    values = list(range(10, 10 + n))
    assert utils.pad_to_power_of_two(values) == jutils.pad_to_power_of_two(values)
    assert utils.pad_to_power_of_two(values, 7) == jutils.pad_to_power_of_two(values, 7)
