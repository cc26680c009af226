"""The reference put in the program's place: the same calls as
`kzgbench/system.py::Port`, computed in plain Python and PyTorch from the
SRS's secret, which the benchmark draws itself.

With the secret s, every value has a closed form: the SRS powers are
s^i G and s^i H, a commitment is f(s) G, the witness for (x, y) is
((f(s) - y) / (s - x)) G, and a proof pi of (z, y) for C is valid exactly
when (s - z) pi = C - y G. So a polynomial of 2^24 coefficients is
committed by one exact evaluation (`fr.evaluate`) and one scalar
multiplication, not by a multi-scalar multiplication.

The control runs this class with one guarantee of the configuration
broken, full-width scalars: `scalar_bits` keeps only the low bits of every
scalar the program would multiply a point by: the SRS's powers s^i, each
coefficient of a committed polynomial (a narrower multi-scalar
multiplication), and the challenge z in the verifier's (s - z).
"""

from . import fr, judge
from .bls import G1, G2, R, g1_compress, g2_compress


class ReferenceSystem:
    name = "reference"

    def __init__(self, device, scalar_bits: int | None = None):
        self.device = device
        self.scalar_bits = scalar_bits
        self._at_s = {}

    def _narrow(self, k: int) -> int:
        return k if self.scalar_bits is None else k & ((1 << self.scalar_bits) - 1)

    def setup_srs(self, secret: int, g1_powers: int, g2_powers: int):
        return {"s": secret % R, "g1": g1_powers, "g2": g2_powers}

    def polynomial(self, words):
        return words

    def g1_inputs(self, affine_points) -> list:
        return [G1.from_affine(p) for p in affine_points]

    def _eval(self, words, xs) -> list:
        return fr.evaluate(words, xs, keep_bits=self.scalar_bits)

    def _f_at_s(self, srs, words) -> int:
        """f(s), kept by the words' identity (the entry holds the words, so
        the identity is not reused while it lives)."""
        key = (id(words), srs["s"])
        if key not in self._at_s:
            self._at_s[key] = (words, self._eval(words, [srs["s"]])[0])
        return self._at_s[key][1]

    def commit(self, srs, words):
        return G1.mul(G1.gen, self._f_at_s(srs, words))

    def evaluate(self, words, x: int) -> int:
        return self._eval(words, [x])[0]

    def witness(self, srs, words, x: int, y: int):
        s = srs["s"]
        q = (self._f_at_s(srs, words) - y) * pow((s - x) % R, -1, R) % R
        return G1.mul(G1.gen, q)

    def verifier(self, srs):
        return srs

    def verify(self, srs, z: int, y: int, commitment, proof) -> bool:
        return judge.valid(srs["s"], self._narrow(z), y, commitment, proof)

    def sync(self):
        pass

    def g1_bytes(self, point) -> bytes:
        return g1_compress(point)

    def srs_g1_bytes(self, srs, indices) -> list:
        return [g1_compress(G1.mul(G1.gen, self._narrow(pow(srs["s"], i, R)))) for i in indices]

    def srs_g2_bytes(self, srs, indices) -> list:
        return [g2_compress(G2.mul(G2.gen, self._narrow(pow(srs["s"], i, R)))) for i in indices]

    def reset_launches(self):
        pass

    def launches(self) -> dict:
        return {}
