"""PeerDAS cells and cell proofs (EIP-7594; consensus-specs,
`specs/fulu/polynomial-commitments-sampling.md`) in Python integers and
plain PyTorch, for the tests and the benchmark's check. It imports nothing
of the program.

Sizes are parameters: n = FIELD_ELEMENTS_PER_BLOB, l =
FIELD_ELEMENTS_PER_CELL, 2n / l cells a blob (the spec's 4096, 64, 128).

The spec's own functions, written as it writes them: `fft_field`,
`bit_reversal_permutation`, `polynomial_eval_to_coeff`, `coset_for_cell`,
`compute_cells` (every cell value by `evaluate_polynomialcoeff`),
`vanishing_polynomialcoeff`, `divide_polynomialcoeff` and
`compute_kzg_proof_multi_impl` (the quotient by long division, then a
linear combination over the SRS points it is given), and the universal
equation of `verify_cell_kzg_proof_batch_impl`.

Departures from the spec text:
  * `verify_cell_kzg_proof_batch_impl` takes the challenge r as an argument
    (the reference hashes nothing) and the secret s, and checks the
    pairing equation e(LL, [s^l]_2) = e(RL, [1]_2) as s^l LL = RL in G1,
    which holds exactly when the pairing equation does;
  * `extension` gives the same values as `compute_cells` by the spec's
    `fft_field` over the 2n-th roots of the zero-padded coefficients, in
    bit-reversed order, instead of 2n Horner evaluations;
  * the closed forms from the secret s, which the benchmark checks against:
    proof_k = ((f(s) - I_k(s)) / (s^l - h_k^l)) G (`proofs_from_secret`),
    and a cell is valid exactly when (s^l - h_k^l) pi = C - I_k(s) G
    (`cell_valid`). I_k(s) is the barycentric form over the coset:
    I_k(s) = (s^l - h_k^l) sum_i e_i z_i / (l h_k^l (s - z_i)).
"""

import torch

from . import fr
from .bls import G1, R

PRIMITIVE_ROOT_OF_UNITY = 7


def compute_roots_of_unity(order: int) -> list:
    root = pow(PRIMITIVE_ROOT_OF_UNITY, (R - 1) // order, R)
    out = [1]
    for _ in range(order - 1):
        out.append(out[-1] * root % R)
    return out


def reverse_bits(k: int, order: int) -> int:
    return int(format(k, f"0{order.bit_length() - 1}b")[::-1], 2) if order > 1 else 0


def bit_reversal_permutation(seq) -> list:
    return [seq[reverse_bits(i, len(seq))] for i in range(len(seq))]


def _fft_field(vals, roots):
    if len(vals) == 1:
        return vals
    left = _fft_field(vals[::2], roots[::2])
    right = _fft_field(vals[1::2], roots[::2])
    out = [0] * len(vals)
    for i, (x, y) in enumerate(zip(left, right)):
        yr = y * roots[i] % R
        out[i] = (x + yr) % R
        out[i + len(left)] = (x - yr) % R
    return out


def fft_field(vals, roots, inv: bool = False) -> list:
    if inv:
        invlen = pow(len(vals), R - 2, R)
        return [x * invlen % R for x in _fft_field(vals, roots[0:1] + roots[:0:-1])]
    return _fft_field(vals, roots)


def polynomial_eval_to_coeff(blob) -> list:
    """The coefficients of a blob given in bit-reversed evaluation form."""
    return fft_field(bit_reversal_permutation(list(blob)), compute_roots_of_unity(len(blob)),
                     inv=True)


def evaluate_polynomialcoeff(coeffs, z: int) -> int:
    y = 0
    for c in reversed(coeffs):
        y = (y * z + c) % R
    return y


def coset_for_cell(k: int, n: int, l: int) -> list:
    roots = bit_reversal_permutation(compute_roots_of_unity(2 * n))
    return roots[l * k:l * (k + 1)]


def compute_cells(blob, l: int) -> list:
    """The spec's `compute_cells`: 2n / l cells of l values, each value one
    evaluation of the blob's polynomial (O(n^2): small sizes only)."""
    n = len(blob)
    coeffs = polynomial_eval_to_coeff(blob)
    return [[evaluate_polynomialcoeff(coeffs, z) for z in coset_for_cell(k, n, l)]
            for k in range(2 * n // l)]


def extension(coeffs) -> list:
    """The 2n values of the extension in bit-reversed order, the cells'
    values end to end: the spec's `fft_field` of the zero-padded
    coefficients."""
    n = len(coeffs)
    return bit_reversal_permutation(
        fft_field(list(coeffs) + [0] * n, compute_roots_of_unity(2 * n)))


def vanishing_polynomialcoeff(xs) -> list:
    p = [1]
    for x in xs:
        p = [(a - x * b) % R for a, b in zip([0] + p, p + [0])]
    return p


def divide_polynomialcoeff(a, b) -> list:
    a = list(a)
    out = []
    apos, bpos = len(a) - 1, len(b) - 1
    diff = apos - bpos
    binv = pow(b[bpos], -1, R)
    while diff >= 0:
        quot = a[apos] * binv % R
        out.insert(0, quot)
        for i in range(bpos, -1, -1):
            a[diff + i] = (a[diff + i] - b[i] * quot) % R
        apos -= 1
        diff -= 1
    return out


def g1_lincomb(points, scalars):
    acc = G1.inf
    for p, k in zip(points, scalars):
        acc = G1.add(acc, G1.mul(p, k % R))
    return acc


def compute_kzg_proof_multi_impl(coeffs, zs, srs_g1):
    """(proof, ys) of the polynomial at the points zs: the quotient by the
    vanishing polynomial, by long division, committed over the G1 SRS points
    `srs_g1` (Jacobian triples)."""
    ys = [evaluate_polynomialcoeff(coeffs, z) for z in zs]
    quotient = divide_polynomialcoeff(coeffs, vanishing_polynomialcoeff(zs))
    return g1_lincomb(srs_g1[:len(quotient)], quotient), ys


def interpolate_polynomialcoeff(xs, ys) -> list:
    """Lagrange interpolation: the coefficients of the polynomial of degree
    < len(xs) through (xs, ys)."""
    out = [0] * len(xs)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num, den = [1], 1
        for j, xj in enumerate(xs):
            if j != i:
                num = [(a - xj * b) % R for a, b in zip([0] + num, num + [0])]
                den = den * (xi - xj) % R
        scale = yi * pow(den, -1, R) % R
        out = [(o + scale * c) % R for o, c in zip(out, num)]
    return out


def verify_cell_kzg_proof_batch_impl(commitments, commitment_indices, cell_indices, cells,
                                     proofs, r: int, s: int, n: int) -> bool:
    """The spec's universal equation, with the challenge r given and the
    pairing check e(LL, [s^l]_2) = e(RL, [1]_2) made as s^l LL = RL.
    Points are Jacobian triples."""
    l = len(cells[0])
    r_pows = [pow(r, k, R) for k in range(len(cells))]
    ll = g1_lincomb(proofs, r_pows)
    weights = [0] * len(commitments)
    for k, i in enumerate(commitment_indices):
        weights[i] = (weights[i] + r_pows[k]) % R
    rlc = g1_lincomb(commitments, weights)
    interp = [0] * l
    for k, cell in enumerate(cells):
        coeffs = interpolate_polynomialcoeff(coset_for_cell(cell_indices[k], n, l), cell)
        interp = [(a + r_pows[k] * c) % R for a, c in zip(interp, coeffs)]
    rli = G1.mul(G1.gen, evaluate_polynomialcoeff(interp, s))
    shifts = [coset_for_cell(k, n, l)[0] for k in cell_indices]
    rlp = g1_lincomb(proofs, [rk * pow(h, l, R) for rk, h in zip(r_pows, shifts)])
    rl = G1.add(G1.add(rlc, G1.neg(rli)), rlp)
    return G1.eq(G1.mul(ll, pow(s, l, R)), rl)


# ---- closed forms from the secret ------------------------------------------------------


def _weights(s: int, n: int, l: int):
    """w_k,i = z_i / (l h_k^l (s - z_i)) over every cell's coset, cell-major,
    and 1 / (s^l - h_k^l) a cell: the barycentric weights of I_k(s)."""
    points = bit_reversal_permutation(compute_roots_of_unity(2 * n))
    inv = _batch_inv([(s - z) % R for z in points])
    hl = [pow(points[l * k], l, R) for k in range(2 * n // l)]
    scale = _batch_inv([l * h % R for h in hl])
    w = [points[i] * inv[i] % R * scale[i // l] % R for i in range(2 * n)]
    return w, _batch_inv([(pow(s, l, R) - h) % R for h in hl])


def _batch_inv(values) -> list:
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % R
    inv = pow(acc, -1, R)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv % R
        inv = inv * values[i] % R
    return out


class Cells:
    """The cells and the proof scalars of blobs of n elements in cells of l,
    for the secret s. The weights are made once; each blob costs two FFTs
    and 2n products."""

    def __init__(self, s: int, n: int, l: int):
        self.s, self.n, self.l = s % R, n, l
        self.w, self.zinv = _weights(self.s, n, l)

    def blob(self, values):
        """(the 2n extension values, cell-major, and the 2n / l proof
        scalars q_k = (f(s) - I_k(s)) / (s^l - h_k^l)) of one blob."""
        coeffs = polynomial_eval_to_coeff(values)
        ext = extension(coeffs)
        fs = evaluate_polynomialcoeff(coeffs, self.s)
        q = []
        for k in range(2 * self.n // self.l):
            lo = k * self.l
            part = sum(e * w for e, w in zip(ext[lo:lo + self.l], self.w[lo:lo + self.l])) % R
            q.append((fs * self.zinv[k] - part) % R)
        return ext, q


def interpolant_at(cell, k: int, n: int, s: int) -> int:
    """I_k(s) for the values `cell` on cell k's coset."""
    l = len(cell)
    zs = coset_for_cell(k, n, l)
    hl = pow(zs[0], l, R)
    inv = _batch_inv([(s - z) % R for z in zs])
    total = sum(e * z % R * i for e, z, i in zip(cell, zs, inv)) % R
    return (pow(s, l, R) - hl) * total % R * pow(l * hl % R, -1, R) % R


def cell_valid(s: int, k: int, cell, commitment, proof, n: int) -> bool:
    """Whether `proof` proves `cell` on coset k for `commitment`:
    (s^l - h_k^l) pi = C - I_k(s) G."""
    l = len(cell)
    hl = pow(coset_for_cell(k, n, l)[0], l, R)
    lhs = G1.mul(proof, (pow(s, l, R) - hl) % R)
    return G1.eq(lhs, G1.add(commitment, G1.neg(G1.mul(G1.gen, interpolant_at(cell, k, n, s)))))


class FixedBase:
    """k G by a table of d 2^(8w) G, w < 32, d < 256: at most 32 additions a
    product, no doubling."""

    BITS = 8

    def __init__(self, point=G1.gen, group=G1):
        self.group = group
        self.table = []
        base = point
        for _ in range(-(-256 // self.BITS)):
            row = [group.inf, base]
            for _ in range((1 << self.BITS) - 2):
                row.append(group.add(row[-1], base))
            self.table.append(row)
            for _ in range(self.BITS):
                base = group.dbl(base)

    def mul(self, k: int):
        acc, w = self.group.inf, 0
        while k:
            d = k & ((1 << self.BITS) - 1)
            if d:
                acc = self.group.add(acc, self.table[w][d])
            k >>= self.BITS
            w += 1
        return acc


def values(words: torch.Tensor) -> list:
    """Field elements of (8, ...) Montgomery words, flattened in C order."""
    return fr.limbs_to_ints(fr.from_mont(fr.limbs_of_words(words.reshape(words.shape[0], -1))))


def mont_words(values_, device) -> torch.Tensor:
    """(8, len) int32 Montgomery words of field elements."""
    buf = b"".join((v * (1 << 256) % R).to_bytes(32, "little") for v in values_)
    w = torch.frombuffer(bytearray(buf), dtype=torch.int32).reshape(-1, 8)
    return w.T.contiguous().to(device)
