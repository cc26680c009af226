"""The group NTT (`kzg_tpu_torch.ntt.group.group_ntt`) on the CPU: over G1
on Jacobian inputs with a batch axis (two rows of 8 points, one at
infinity), the forward transform equals the plain reference's O(d^2) DFT
sum_i x_i omega^(ik) (Python integers, `kzgbench/reference/bls.py`), its
bit-reversed form is the same points permuted, and the inverse, scaled by
1/d, gives the input back. The Lagrange SRS's `_group_intt` runs the same
transform (`test_torch_lagrange.py`)."""

import pytest
import torch

from kzg_tpu_torch import config
from kzg_tpu_torch.curve import G1, g1_from_device, g1_to_device
from kzg_tpu_torch.fields.cuda_field import bitrev_perm
from kzg_tpu_torch.ntt import Domain
from kzg_tpu_torch.ntt.group import group_ntt
from kzg_tpu_torch.oracle.field import Fp
from kzgbench.reference.bls import G1 as RG1, R

EXP = 3
D = 1 << EXP


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _scalars():
    return [[(7 ** (3 * i + 5 * row + 1)) % R for i in range(D)] for row in range(2)]


def _host(point):
    return None if point is None else (point[0].n, point[1].n)


@pytest.fixture(scope="module")
def points():
    """Two rows of D Jacobian points k G (row 1's point 2 at infinity),
    as (12, 2, D) device words, and the same as reference points."""
    rows = [[RG1.mul(RG1.gen, k) for k in ks] for ks in _scalars()]
    rows[1][2] = RG1.inf
    flat = [RG1.affine(p) for row in rows for p in row]
    dev = g1_to_device([None if a is None else (Fp(a[0]), Fp(a[1])) for a in flat], "cpu")
    return tuple(t.reshape(t.shape[0], 2, D) for t in dev), rows


def _dft(row, omega):
    out = []
    for k in range(D):
        acc = RG1.inf
        for i, p in enumerate(row):
            acc = RG1.add(acc, RG1.mul(p, pow(omega, i * k, R)))
        out.append(RG1.affine(acc))
    return out


@pytest.fixture(scope="module")
def forward(points):
    return group_ntt(G1, points[0], Domain(EXP))


def test_forward_equals_the_dft(points, forward):
    assert forward[0].shape == (12, 2, D)
    got = g1_from_device(tuple(t.reshape(12, -1) for t in forward))
    want = sum((_dft(row, Domain(EXP).omega) for row in points[1]), [])
    assert [_host(p) for p in got] == want


def test_inverse_gives_the_input_back(points, forward):
    back = group_ntt(G1, forward, Domain(EXP), inverse=True)
    assert G1.eq(back, points[0]).all()


def test_bit_reversed_order(points, forward):
    rev = group_ntt(G1, points[0], Domain(EXP), bit_reversed=True)
    perm = torch.from_numpy(bitrev_perm(EXP))
    assert all(torch.equal(a, torch.index_select(b, -1, perm)) for a, b in zip(rev, forward))


def test_length_is_checked(points):
    with pytest.raises(ValueError):
        group_ntt(G1, points[0], Domain(EXP + 1))
