"""The reference against the golden bytes of tests/vectors.json (the
coeff_2e10 vector: commitment and witness of a 2^10-coefficient
polynomial) and against Python integers."""

import json
import os
import random

import pytest
import torch

from conftest import ROOT

from kzgbench.reference import fr, judge
from kzgbench.reference.bls import G1, G2, R, g1_compress, g2_compress

VEC = json.load(open(os.path.join(ROOT, "tests", "vectors.json")))


def _words(values, mont=True):
    enc = [v * (1 << 256) % R for v in values] if mont else values
    return torch.tensor([[(v >> (32 * j)) & 0xFFFFFFFF for v in enc] for j in range(8)],
                        dtype=torch.int64).to(torch.int32)


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def test_generators_encode_as_the_standard_bytes():
    assert g1_compress(G1.gen).hex() == VEC["generators"]["g1"]
    assert g2_compress(G2.gen).hex() == VEC["generators"]["g2"]


def test_coeff_2e10_commitment_and_witness():
    v = VEC["configs"]["coeff_2e10"]
    rng = random.Random(VEC["seed"])
    coeffs = [rng.randrange(R) for _ in range(v["n"])]
    x = rng.randrange(R)
    assert hex(x) == v["open_x"]
    s = int(VEC["secret"], 16) % R
    ((c, y, w),) = judge.openings(_words(coeffs), s, [x])
    assert c.hex() == v["commit"]
    assert hex(y) == v["open_y"]
    assert w.hex() == v["witness"]
    # the verifier's equation accepts it and rejects y + 1
    fs = _horner(coeffs, s)
    com, pi = judge.proof(s, fs, x, y)
    assert g1_compress(com).hex() == v["commit"] and g1_compress(pi).hex() == v["witness"]
    assert judge.valid(s, x, y, com, pi)
    assert not judge.valid(s, x, y + 1, com, pi)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000, 4097])
def test_evaluate_against_horner(n):
    rng = random.Random(n)
    vals = [rng.randrange(R) for _ in range(n)]
    xs = [0, 1, R - 1] + [rng.randrange(R) for _ in range(3)]
    assert fr.evaluate(_words(vals), xs) == [_horner(vals, x) for x in xs]
    assert fr.evaluate(_words(vals, mont=False), xs, mont=False) == [_horner(vals, x) for x in xs]
    low = [v & ((1 << 128) - 1) for v in vals]
    assert fr.evaluate(_words(vals), xs, keep_bits=128) == [_horner(low, x) for x in xs]


def test_from_mont_edges():
    vals = [0, 1, 2, R - 1, R - 2, (1 << 254) % R, 0xFFFFFFFF]
    assert fr.limbs_to_ints(fr.from_mont(fr.limbs_of_words(_words(vals)))) == vals


def test_srs_bytes():
    s = 0x1234567
    g1, g2 = judge.srs_bytes(s, [0, 1, 5], [0, 1])
    assert g1[0] == g1_compress(G1.gen) and g2[0] == g2_compress(G2.gen)
    assert g1[2] == g1_compress(G1.mul(G1.gen, pow(s, 5, R)))
    assert g2[1] == g2_compress(G2.mul(G2.gen, s))
