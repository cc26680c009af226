"""Faults planted under the timed path, for the test that the check catches
them (`tests/test_kzgbench_control.py`) and for `control.py`. Each wraps a
system (the program or the reference in its place) and breaks one call:

  * "stale": a step returns its state unchanged: from the second call on,
    every commitment is the first one and every verdict the first one;
  * "half": half of the batch left out: a commitment over the first half
    of the coefficients only; a verification without the y G half of its
    second pairing's point (y taken as 0);
  * "altered": an answer altered where it is produced: every fifth
    evaluation returns y + 1, every fifth verdict is negated;
  * "lost": an answer that never comes: every fifth evaluation or
    verification raises.

The exchange between chips has no fault here: every cell runs on one card.
"""

from .reference.bls import R

FAULTS = ("stale", "half", "altered", "lost")


class Lost(RuntimeError):
    """The planted fault "lost": a call that never answers."""


class Faulty:
    def __init__(self, base, fault: str):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        self.base, self.fault = base, fault
        self.name = f"{base.name}+{fault}"
        self._calls = {}
        self._first = {}
        self._words = {}

    def __getattr__(self, attr):
        return getattr(self.base, attr)

    def _count(self, what: str) -> int:
        self._calls[what] = self._calls.get(what, 0) + 1
        return self._calls[what]

    def polynomial(self, words):
        poly = self.base.polynomial(words)
        self._words[id(poly)] = words
        return poly

    def commit(self, srs, poly):
        if self.fault == "half":
            words = self._words[id(poly)]
            return self.base.commit(srs, self.base.polynomial(
                words[:, : max(1, words.shape[-1] // 2)].contiguous()))
        out = self.base.commit(srs, poly)
        return self._first.setdefault("commit", out) if self.fault == "stale" else out

    def evaluate(self, poly, x: int) -> int:
        k = self._count("evaluate")
        if self.fault == "lost" and k % 5 == 0:
            raise Lost("evaluation lost")
        y = self.base.evaluate(poly, x)
        if self.fault == "altered" and k % 5 == 0:
            y = (y + 1) % R
        return y

    def verify(self, verifier, z: int, y: int, commitment, proof) -> bool:
        k = self._count("verify")
        if self.fault == "lost" and k % 5 == 0:
            raise Lost("verification lost")
        ok = self.base.verify(verifier, z, 0 if self.fault == "half" else y, commitment, proof)
        if self.fault == "stale":
            ok = self._first.setdefault("verify", ok)
        if self.fault == "altered" and k % 5 == 0:
            ok = not ok
        return ok
