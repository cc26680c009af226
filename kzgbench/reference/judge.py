"""What the reference says each output of a run should be, from the secret
s and the benchmark's own inputs; see `system.py` for the closed forms."""

from . import fr
from .bls import G1, G2, R, g1_compress, g2_compress


def srs_indices(rand, g1_powers: int, g2_powers: int, count: int):
    """The SRS powers the check reads: the first two and the last of each
    group, and `count` G1 powers drawn with `rand`."""
    g1 = {0, 1, g1_powers - 1} | {rand.randrange(g1_powers) for _ in range(count)}
    g2 = {0, 1, g2_powers - 1}
    return sorted(g1), sorted(g2)


def srs_bytes(s: int, g1_indices, g2_indices):
    return ([g1_compress(G1.mul(G1.gen, pow(s, i, R))) for i in g1_indices],
            [g2_compress(G2.mul(G2.gen, pow(s, i, R))) for i in g2_indices])


def srs_mismatches(s: int, sample) -> int:
    """How many powers of a read SRS sample (G1 indices, G2 indices, G1
    bytes, G2 bytes) differ from s^i G and s^i H."""
    g1_idx, g2_idx, got1, got2 = sample
    want1, want2 = srs_bytes(s, g1_idx, g2_idx)
    return sum(a != b for a, b in zip(got1 + got2, want1 + want2))


def openings(words, s: int, xs) -> list:
    """(commitment bytes, y, witness bytes) of the polynomial given by its
    Montgomery words opened at each x of xs."""
    values = fr.evaluate(words, [s] + list(xs))
    fs = values[0]
    c = g1_compress(G1.mul(G1.gen, fs))
    out = []
    for x, y in zip(xs, values[1:]):
        q = (fs - y) * pow((s - x) % R, -1, R) % R
        out.append((c, y, g1_compress(G1.mul(G1.gen, q))))
    return out


def proof(s: int, at_s: int, z: int, y: int):
    """The commitment and the proof of p(z) = y for a polynomial p with
    p(s) = at_s, as Jacobian points."""
    return (G1.mul(G1.gen, at_s % R),
            G1.mul(G1.gen, (at_s - y) * pow((s - z) % R, -1, R) % R))


def valid(s: int, z: int, y: int, commitment, pi) -> bool:
    """Whether pi proves p(z) = y for the commitment: (s - z) pi = C - y G,
    which is the pairing check e(pi, (s - z) H) = e(C - y G, H)."""
    lhs = G1.mul(pi, (s - z) % R)
    return G1.eq(lhs, G1.add(commitment, G1.neg(G1.mul(G1.gen, y % R))))
