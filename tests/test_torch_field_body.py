"""The one-thread field body of `kzg_tpu_torch/csrc/field.cuh` (fe_mul,
fe_sqr, fe_add, fe_sub: PTX carry chains, each row split by the parity of
the word index, CIOS, the squaring's doubled off-diagonal sum and its
stand-alone reduction) run instruction by instruction in
`tests/field_body_model.py`, against Python integers and against the JAX
package's `LimbField` and `PallasFieldOps` products on the same operands:
every ordered pair of `bench.field_body.carry_operands` and 10^4 seeded
random pairs, over Fr and Fp. The model also asserts that no chain drops a
carry. Tolerance 0: all of it is integer math.

The JAX side runs on the CPU backend (tests/conftest.py): `LimbField.mul`
and `.sqr`, and `PallasFieldOps.mul` (the Pallas kernel's body; its sqr is
mul(a, a)) jitted as plain JAX on limb arrays, as the JAX tests run it
without a TPU.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from field_body_model import Body
from kzg_tpu import fields as jf
from kzg_tpu.fields import pallas_field as jpf
from kzg_tpu_torch.bench import field_body as fbench
from kzg_tpu_torch.constants import P, R

HEADER = Path(__file__).resolve().parent.parent / "kzg_tpu_torch" / "csrc" / "field.cuh"
FIELDS = [(R, 8, jf.FR, "FR"), (P, 12, jf.FP, "FP")]
IDS = ["Fr", "Fp"]
RANDOM_PAIRS = 10_000


def _operands(mod, words, seed):
    """The carry set's ordered pairs, then RANDOM_PAIRS seeded random pairs
    below mod."""
    xs, ys = fbench.carry_pairs(mod, words)
    rs = np.random.default_rng(seed)
    for out in (xs, ys):
        raw = rs.integers(0, 1 << 32, size=(RANDOM_PAIRS, words), dtype=np.uint64)
        out += [int(sum(int(w) << (32 * k) for k, w in enumerate(row))) % mod for row in raw]
    return xs, ys


@pytest.fixture(scope="module", params=FIELDS, ids=IDS)
def case(request):
    mod, words, jfield, tag = request.param
    body = Body(mod, words)
    xs, ys = _operands(mod, words, seed=words)
    a, b = body.words(xs), body.words(ys)
    return {"mod": mod, "words": words, "jfield": jfield, "tag": tag, "body": body,
            "xs": xs, "ys": ys, "mul": Body.ints(body.fe_mul(a, b)),
            "sqr": Body.ints(body.fe_sqr(a)), "add": Body.ints(body.fe_add(a, b)),
            "sub": Body.ints(body.fe_sub(a, b)),
            "r_inv": pow(1 << (32 * words), -1, mod)}


def test_model_against_python_ints(case):
    mod, r_inv, xs, ys = case["mod"], case["r_inv"], case["xs"], case["ys"]
    assert case["mul"] == [x * y * r_inv % mod for x, y in zip(xs, ys)]
    assert case["sqr"] == [x * x * r_inv % mod for x in xs]
    assert case["add"] == [(x + y) % mod for x, y in zip(xs, ys)]
    assert case["sub"] == [(x - y) % mod for x, y in zip(xs, ys)]


def test_model_against_jax_products(case):
    """The model's products and squares equal `LimbField.mul` / `.sqr` and
    the Pallas kernel's body `PallasFieldOps.mul`, limb for limb
    (the JAX package's 16-bit limbs hold the same integers)."""
    jfield = case["jfield"]
    a = jnp.asarray(jfield.from_ints(case["xs"]))
    b = jnp.asarray(jfield.from_ints(case["ys"]))
    assert jfield.to_ints(jfield.mul(a, b)) == case["mul"]
    assert jfield.to_ints(jfield.sqr(a)) == case["sqr"]
    body_mul = jax.jit(jpf.PallasFieldOps(jfield).mul)
    assert jfield.to_ints(body_mul(a, b)) == case["mul"]
    assert jfield.to_ints(body_mul(a, a)) == case["sqr"]


def test_model_mirrors_the_header(case):
    """The model's constants are the header's (its modulus words and n'),
    and the header has the pieces the model runs: the split rows, CIOS, the
    reduction's rounds, a squaring of its own (not fe_mul(a, a)) whose
    point-kernel overload `sqr` takes it."""
    text = HEADER.read_text()
    words = re.search(rf"#define KZG_{case['tag']}_MOD((?:.*\\\n)*.*)", text).group(1)
    p = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", words)]
    assert p == [int(w) for w in case["body"].p]
    tag = "Fr" if case["tag"] == "FR" else "Fp"
    nprime = re.search(rf"struct {tag} \{{.*?NPRIME = (0x[0-9a-f]+)u", text, re.S).group(1)
    assert int(nprime, 16) == int(case["body"].nprime)
    for name in ("row_mul", "row_mad", "row_mad_shift", "cios_row", "redc_round", "fe_redc",
                 "sqr_row", "fe_reduce_once", "fe_add", "fe_sub", "fe_mul", "fe_sqr"):
        assert re.search(rf"__device__ __forceinline__ \w+(<[^>]*>)? {name}\(", text), name
    sqr = text[text.index("Fe<F> fe_sqr("):]
    sqr = sqr[:sqr.index("\n}\n")]
    assert "fe_mul" not in sqr and "__funnelshift_l" in sqr and "fe_redc" in sqr
    point = (HEADER.parent / "point.cuh").read_text()
    assert "FpE sqr(const FpE& a) { return fe_sqr<Fp>(a); }" in point
