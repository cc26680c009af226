"""The scan-based `batch_inv` (Montgomery's trick on one pair scan of
`field_scan`, its plain version on the CPU) against `kzg_tpu`'s
product-tree batch_inv, zeros interleaved, over Fr, Fp and Fp2, with rows
> 1, and against Python's inverses. The batch_inv cases of
test_torch_scan.py, a file of their own so that a parallel run gives the
two halves two workers.

Tolerance 0: exact integer arithmetic. Inputs from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu import fields as jf
from kzg_tpu.curve import FP2A as JFP2
from kzg_tpu_torch.constants import P
from kzg_tpu_torch.curve import FP2
from kzg_tpu_torch.fields import FP

from test_torch_scan import _cpu_device, FIELDS, IDS, _ints, _same  # noqa: F401


@pytest.mark.parametrize("shape", [(1,), (33,), (3, 255), (2, 1000)],
                         ids=["1", "33", "3x255", "2x1000"])
@pytest.mark.parametrize("field,jfield,mod", FIELDS, ids=IDS)
def test_batch_inv_matches_jax(field, jfield, mod, shape):
    n = int(np.prod(shape))
    xs = _ints(20 + n, mod, n)
    xs[n // 2] = 0
    a = torch.from_numpy(field.encode(xs)).reshape((field.W,) + shape)
    ja = jnp.asarray(jfield.encode(xs)).reshape((2 * field.W,) + shape)
    got = field.batch_inv(a)
    _same(got, jfield.batch_inv(ja))
    assert field.decode(got) == [pow(x, -1, mod) if x else 0 for x in xs]


@pytest.mark.parametrize("shape", [(5,), (3, 33)], ids=["5", "3x33"])
def test_fp2_batch_inv_matches_jax(shape):
    n = int(np.prod(shape))
    c0, c1 = _ints(90 + n, P, n), _ints(91 + n, P, n)
    c0[1] = c1[1] = 0  # the zero of Fp2
    c1[2] = 0
    a = torch.stack([torch.from_numpy(FP.encode(c)) for c in (c0, c1)], dim=1)
    a = a.reshape((FP.W, 2) + shape)
    ja = jnp.stack([jnp.asarray(jf.FP.encode(c)) for c in (c0, c1)], axis=1)
    ja = ja.reshape((2 * FP.W, 2) + shape)
    got = FP2.batch_inv(a)
    _same(got, JFP2.batch_inv(ja))
