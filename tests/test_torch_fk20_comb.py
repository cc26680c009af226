"""The fixed-base comb (`cuda_ops.fk20_comb` on `msm.pippenger.comb_table`:
FK20's MSMs on its fixed points) on the CPU, on its plain twin.

  * The comb's products and their sum equal the digit ladder's
    (`ladder_rounds` on `ladder_table`, and `ladder_msm`) and the host's
    oracle, in affine form, on four base points at random Z (the last one
    infinite), lane by lane, for each scalar of `bench.comb.EDGE_SCALARS`
    (0, 1, r - 1, every digit 15, r: the last window meets P == -Q, r + 30:
    it meets P == Q) and for random scalars below r.
  * Sampled entries of the comb table equal d 2^(4 w) P by the oracle, and
    its infinity mask marks the infinite point.

Tolerance 0: exact integer arithmetic. The kernel itself runs on the card
in `tests/test_torch_cuda.py`. On the plain twins the table takes ~10 s
(252 doublings a window chain, then the ladder table's adds and one
`to_affine` over 64 x 4 points), the comb ~5 s and the ladder ~10 s.
"""

import pytest
import torch

from kzg_tpu_torch import config
from kzg_tpu_torch.bench import comb as cbench
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.curve import G1, cuda_ops, g1_from_device
from kzg_tpu_torch.msm.pippenger import (
    SMALL_MSM_WINDOW, _std_digits_msb, comb_table, ladder_msm, point_sum,
)
from kzg_tpu_torch.oracle import ec_add, ec_mul

CASES = list(cbench.EDGE_SCALARS) + ["random"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


@pytest.fixture(scope="module")
def edge():
    """(base, oracle points, scalars (8, cases, 4), comb table)."""
    base, pts, scalars = cbench.edge_case("cpu")
    return base, pts, scalars, comb_table(base)


@pytest.fixture(scope="module")
def products(edge):
    """Per lane, the comb's and the ladder's products, oracle points
    (cases, 4), and the comb's and the ladder's sums a case."""
    base, _, scalars, table = edge
    comb = cuda_ops.fk20_comb(*table, scalars)
    shape = tuple(scalars.shape[1:])
    tx, ty, p_inf = G1.ladder_table(base, SMALL_MSM_WINDOW)
    lt = (tx.unsqueeze(2).expand(tx.shape[:2] + shape), ty.unsqueeze(2).expand(ty.shape[:2] + shape),
          p_inf.expand(shape))
    digits = _std_digits_msb(scalars.reshape(8, -1), SMALL_MSM_WINDOW, 64).reshape((64,) + shape)
    ladder = G1.ladder_rounds(*lt, digits, SMALL_MSM_WINDOW)

    def host(p):
        return [g1_from_device(tuple(t[:, c] for t in p)) for c in range(shape[0])]

    return (host(comb), host(ladder), g1_from_device(point_sum(G1, comb)),
            g1_from_device(ladder_msm(G1, lt, scalars)))


def _scalars(scalars, c):
    words = scalars[:, c].to(torch.int64) & 0xFFFFFFFF
    return [sum(int(words[k, i]) << (32 * k) for k in range(8)) for i in range(words.shape[1])]


def _mul(pt, k):
    return None if pt is None or k % R == 0 else ec_mul(pt, k % R)


@pytest.mark.parametrize("case", CASES)
def test_comb_equals_the_ladder_and_the_oracle(edge, products, case):
    _, pts, scalars, _ = edge
    comb, ladder, comb_sum, ladder_sum = products
    c = CASES.index(case)
    want = [_mul(pt, k) for pt, k in zip(pts, _scalars(scalars, c))]
    assert comb[c] == ladder[c] == want
    total = None
    for q in want:
        total = ec_add(total, q)
    assert comb_sum[c] == ladder_sum[c] == total


@pytest.mark.parametrize("w,d", [(0, 1), (0, 15), (1, 2), (17, 9), (62, 7), (63, 15)])
def test_comb_table_entries(edge, w, d):
    _, pts, _, (rows, p_inf) = edge
    assert p_inf.tolist() == [pt is None for pt in pts]
    entry = rows[w, :, d - 1]  # (P, 24)
    got = g1_from_device((entry[:, :12].T.contiguous(), entry[:, 12:].T.contiguous(), p_inf))
    assert got == [_mul(pt, d << (4 * w)) for pt in pts]
