"""`DAS.verify_cell_kzg_proof_batch` of the port on the CPU (host pairing
engine), at the small size of `test_torch_das.py`: blobs of 64, cells of 4,
32 cells a blob. The proofs come from the plain reference's closed form
(a cell's proof is unique, so they are the port's FK20 proofs too, which
`test_torch_das.py` holds to the same closed form).

It accepts the honest batches: one blob's 32 cells in a shuffled order
(one commitment repeated 32 times), and a batch over two blobs with
repeated commitments, repeated cells and unsorted indices. It rejects each
of the four tamperings of that batch: a cell value + 1, a proof of another
cell, the other blob's commitment, and a wrong cell index. The plain
reference's universal equation, run with the port's challenge, gives the
same verdicts. An empty batch is valid; shapes and indices are checked.
"""

import random

import pytest
import torch

from test_torch_das import _cpu_device, SECRET, N, L, blob  # noqa: F401

from kzg_tpu_torch.curve import g1_to_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.kzg.das import DAS
from kzg_tpu_torch.kzg.srs import setup
from kzg_tpu_torch.oracle.field import Fp
from kzgbench.reference import das as ref
from kzgbench.reference.bls import G1, R, g1_compress

CELLS = 2 * N // L
MIXED = [(0, 5), (1, 3), (0, 31), (0, 5), (1, 0), (1, 17)]  # (blob, cell)
TAMPERS = ("value", "proof", "commitment", "index")


@pytest.fixture(scope="module")
def das():
    return DAS(setup(SECRET, N), N, L)


@pytest.fixture(scope="module")
def blobs():
    """Per blob: (cell values, proofs, commitment), by the reference."""
    cells = ref.Cells(SECRET, N, L)
    g = ref.FixedBase()
    out = []
    for seed in (21, 22):
        values = blob(seed)
        ext, q = cells.blob(values)
        com = g.mul(ref.evaluate_polynomialcoeff(ref.polynomial_eval_to_coeff(values), SECRET))
        out.append(([ext[k * L:(k + 1) * L] for k in range(CELLS)], [g.mul(k) for k in q], com))
    return out


def _device(points):
    return g1_to_device([None if a is None else (Fp(a[0]), Fp(a[1]))
                         for a in (G1.affine(p) for p in points)], "cpu")


def batch(blobs, picks, tamper=None):
    """(commitments, indices, cell values, proofs) of the picked cells as
    host values, with one tampering."""
    cells = [list(blobs[b][0][k]) for b, k in picks]
    proofs = [blobs[b][1][k] for b, k in picks]
    coms = [blobs[b][2] for b, _ in picks]
    idx = [k for _, k in picks]
    if tamper == "value":
        cells[2][1] = (cells[2][1] + 1) % R
    elif tamper == "proof":
        proofs[1] = blobs[1][1][4]
    elif tamper == "commitment":
        coms[0] = blobs[1][2]
    elif tamper == "index":
        idx[3] = 6
    return coms, idx, cells, proofs


def verify(das, coms, idx, cells, proofs) -> bool:
    words = ref.mont_words(sum(cells, []), "cpu").reshape(FR.W, len(idx), L)
    return das.verify_cell_kzg_proof_batch(_device(coms), idx, words, _device(proofs))


def test_one_blob_all_cells_shuffled(das, blobs):
    order = list(range(CELLS))
    random.Random(5).shuffle(order)
    assert verify(das, *batch(blobs, [(0, k) for k in order]))


@pytest.mark.parametrize("tamper", (None,) + TAMPERS)
def test_mixed_batch(das, blobs, tamper):
    assert verify(das, *batch(blobs, MIXED, tamper)) == (tamper is None)


@pytest.mark.parametrize("tamper", (None,) + TAMPERS)
def test_reference_equation_agrees(das, blobs, tamper):
    """The plain reference's equation with the port's challenge r; and the
    closed form cell by cell."""
    coms, idx, cells, proofs = batch(blobs, MIXED, tamper)
    encoded = [g1_compress(c) for c in coms]
    unique = list(dict.fromkeys(encoded))
    com_idx = [unique.index(c) for c in encoded]
    r = das._challenge(unique, com_idx, idx, sum(cells, []), [g1_compress(p) for p in proofs])
    points = [coms[encoded.index(c)] for c in unique]
    got = ref.verify_cell_kzg_proof_batch_impl(points, com_idx, idx, cells, proofs, r, SECRET, N)
    assert got == (tamper is None)
    assert all(ref.cell_valid(SECRET, k, cell, c, p, N)
               for k, cell, c, p in zip(idx, cells, coms, proofs)) == (tamper is None)


def test_empty_batch_and_checks(das, blobs):
    empty = tuple(torch.zeros((12, 0), dtype=torch.int32) for _ in range(3))
    assert das.verify_cell_kzg_proof_batch(empty, [], torch.zeros((FR.W, 0, L),
                                                                  dtype=torch.int32), empty)
    coms, idx, cells, proofs = batch(blobs, MIXED[:2])
    with pytest.raises(ValueError):
        verify(das, coms, [0, CELLS], cells, proofs)
    with pytest.raises(ValueError):
        verify(das, coms, idx[:1], cells[:1], proofs)
