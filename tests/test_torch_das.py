"""PeerDAS cells and FK20 cell proofs of the port (`kzg_tpu_torch.kzg.das`)
on the CPU, at a small size of the deployment's shape: blobs of 64 field
elements, cells of 4, 32 cells a blob over an extended domain of 128, and
an SRS of 64 G1 and 64 G2 powers of a seeded secret.

The port's cells and proofs equal the plain reference's
(`kzgbench/reference/das.py`: the spec's FFTs for the cells, the closed
form ((f(s) - I_k(s)) / (s^4 - h_k^4)) G for the proofs) byte for byte, on
blobs from three seeds, in one call on all three blobs, and the first
seed's blob in a call of its own, which equals its blob of the batched
call. The cells also equal the
spec's literal `compute_cells` (every value by Horner).

On the plain twins FK20's set-up takes ~80 s (the group NTTs ~45 s, the
comb table ~35 s) and a call ~75 s whatever the number of blobs (the
twins are overhead-bound), so the file makes the set-up once and three
calls.
"""

import random

import pytest
import torch

from kzg_tpu_torch import config
from kzg_tpu_torch.compat.serialize import g1_compress
from kzg_tpu_torch.curve import g1_from_device
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.kzg.das import DAS
from kzg_tpu_torch.kzg.srs import setup
from kzgbench.reference import das as ref
from kzgbench.reference.bls import R, g1_compress as ref_compress

SECRET = 0x5EED_CE11
N, L = 64, 4
SEEDS = (11, 2**31 + 7, 2**40 + 3)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


@pytest.fixture(scope="module")
def das():
    return DAS(setup(SECRET, N), N, L)


def blob(seed) -> list:
    rng = random.Random(seed)
    return [rng.randrange(R) for _ in range(N)]


def words(blobs) -> torch.Tensor:
    return torch.from_numpy(FR.encode(sum(blobs, []))).reshape(FR.W, len(blobs), N)


def expected(values):
    """(cells as (8, 32, 4) words, proofs as bytes) of one blob, by the
    reference."""
    ext, q = ref.Cells(SECRET, N, L).blob(values)
    g = ref.FixedBase()
    return (ref.mont_words(ext, "cpu").reshape(FR.W, 2 * N // L, L),
            [ref_compress(g.mul(k)) for k in q])


def proof_bytes(proofs, b: int) -> list:
    return [g1_compress(p) for p in g1_from_device(tuple(t[:, b] for t in proofs))]


def check_blob(cells, proofs, b: int, values):
    want_cells, want_proofs = expected(values)
    assert torch.equal(cells[:, b], want_cells)
    assert proof_bytes(proofs, b) == want_proofs


@pytest.fixture(scope="module")
def batched(das):
    blobs = [blob(s) for s in SEEDS]
    return blobs, das.compute_cells_and_kzg_proofs(words(blobs))


def test_cells_match_the_spec(das):
    blobs = [blob(s) for s in SEEDS]
    cells = das.compute_cells(words(blobs))
    assert cells.shape == (FR.W, 3, 2 * N // L, L)
    for b, values in enumerate(blobs):
        assert ref.values(cells[:, b]) == sum(ref.compute_cells(values, L), [])
        # in bit-reversed order the first half of the extension is the blob itself
        assert ref.values(cells[:, b, :N // L]) == values


def test_three_blobs_in_one_call_match_the_reference(batched):
    blobs, (cells, proofs) = batched
    assert cells.shape == (FR.W, 3, 2 * N // L, L) and proofs[0].shape == (12, 3, 2 * N // L)
    for b, values in enumerate(blobs):
        check_blob(cells, proofs, b, values)


def test_one_blob_a_call_matches_the_reference_and_the_batch(das, batched):
    blobs, (cells3, proofs3) = batched
    cells, proofs = das.compute_cells_and_kzg_proofs(words(blobs[:1]))
    check_blob(cells, proofs, 0, blobs[0])
    assert torch.equal(cells[:, 0], cells3[:, 0])
    assert all(torch.equal(a[:, 0], b[:, 0]) for a, b in zip(proofs, proofs3))


def test_shapes_are_checked(das):
    with pytest.raises(ValueError):
        das.compute_cells(torch.zeros((FR.W, N), dtype=torch.int32))
    with pytest.raises(ValueError):
        das.compute_cells_and_kzg_proofs(torch.zeros((FR.W, 1, N // 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        DAS(setup(SECRET, N), 2 * N, L)  # an SRS shorter than the blob
    with pytest.raises(ValueError):
        DAS(setup(SECRET, N), N, 3)
