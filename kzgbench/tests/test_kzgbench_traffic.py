"""The traffic generators give the same inputs for the same seed, other
inputs for another seed, and the same amount of work whatever the seed."""

import torch

from conftest import SMALL, small_cell

from kzgbench import inputs
from kzgbench.harness import Context
from kzgbench.reference.bls import R
from kzgbench.traffic import verify

SEEDS = (1, 2**31 + 11, 2**33 + 5)


def test_derive_is_stable_and_separates():
    assert inputs.derive(5, "x", 3) == inputs.derive(5, "x", 3)
    assert len({inputs.derive(s, "x", k) for s in SEEDS for k in range(4)}) == 12
    assert all(0 <= inputs.derive(s, "pool0") < 2 ** 63 for s in SEEDS)
    assert all(1 <= inputs.fr_point(s, "secret") < R for s in SEEDS)


def test_fr_words_same_seed_same_words():
    a = inputs.fr_words(2**33 + 5, "pool0", 1000, torch.device("cpu"))
    b = inputs.fr_words(2**33 + 5, "pool0", 1000, torch.device("cpu"))
    c = inputs.fr_words(2**33 + 6, "pool0", 1000, torch.device("cpu"))
    assert a.shape == (8, 1000) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    w = a.to(torch.int64) & 0xFFFFFFFF
    values = [sum(int(w[j, i]) << (32 * j) for j in range(8)) for i in range(1000)]
    assert all(v < R for v in values)


def _ctx(bench, seed):
    cell = small_cell(bench, "eip4844_blob.verify")
    return Context(seed, cell.config, cell.mix, None, torch.device("cpu"))


def test_verify_schedule_same_seed_same_requests(bench):
    for seed in SEEDS:
        a = [verify.schedule(_ctx(bench, seed), k) for k in range(160)]
        b = [verify.schedule(_ctx(bench, seed), k) for k in range(160)]
        assert a == b
    assert a != [verify.schedule(_ctx(bench, SEEDS[0]), k) for k in range(160)]


def test_verify_one_tampered_in_each_run_of_sixteen(bench):
    pool = SMALL["eip4844_blob.verify"][1]["pool"]
    for seed in SEEDS:
        reqs = [verify.schedule(_ctx(bench, seed), k) for k in range(16 * 20)]
        for g in range(20):
            group = reqs[16 * g:16 * (g + 1)]
            tampered = [r for r in group if r[1] is not None]
            assert len(tampered) == 1
            b, kind, other = tampered[0]
            assert kind in ("y", "proof") and (other != b) == (kind == "proof")
        assert all(0 <= b < pool for b, _, _ in reqs)


def test_open_points_same_seed(bench):
    from kzgbench.inputs import fr_point

    assert [fr_point(9, "x", k) for k in range(5)] == [fr_point(9, "x", k) for k in range(5)]
    assert fr_point(9, "x", 0) != fr_point(10, "x", 0)
