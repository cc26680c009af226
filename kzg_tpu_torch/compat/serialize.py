"""Copy of `kzg_tpu/compat/serialize.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package.

Canonical byte encodings interoperable with the Rust reference's
serde_support feature (SURVEY.md §2.2 'Serialization': blstrs exposes the
zkcrypto/ZCash BLS12-381 formats; KZGParams/Polynomial/witnesses derive
serde and round-trip through bincode, reference polynomial.rs:692-710).

Formats (ZCash BLS12-381 spec, as implemented by blstrs/blst):
  Fr           32 bytes little-endian, canonical (< r)
  G1 compressed   48 bytes: big-endian x; byte 0 flags:
                  0x80 compressed, 0x40 infinity, 0x20 y lexicographically
                  largest
  G1 uncompressed 96 bytes: x || y big-endian, same flag bits (0x80 clear)
  G2 compressed   96 bytes: x.c1 || x.c0 (48B each big-endian), flags on
                  byte 0; sort flag compares (y.c1, y.c0) lexicographically
  G2 uncompressed 192 bytes: x.c1 || x.c0 || y.c1 || y.c0

All functions operate on the oracle's point representation (None or a tuple
of oracle field elements) — the compat layer is a host boundary, not a
kernel path; device batches convert via curve.g1_from_device/g2_from_device.
"""

import struct

from ..constants import P, R
from ..oracle.field import Fp, Fp2
from ..oracle import ec_add, on_curve_g1, on_curve_g2


class DecodeError(ValueError):
    pass


def _ec_mul_raw(p, k: int):
    """Scalar multiply WITHOUT reducing k mod r (oracle ec_mul reduces, which
    would make the r-torsion test below vacuous)."""
    acc = None
    add = p
    while k:
        if k & 1:
            acc = ec_add(acc, add)
        add = ec_add(add, add)
        k >>= 1
    return acc


def _in_subgroup(p) -> bool:
    """r-torsion membership. Dispatches to the native C++ engine when built
    (the pure-Python ladder below is the fallback/oracle path)."""
    from .. import native

    if native.available():
        # G2 points carry Fp2 coordinates (oracle Fp2 has .a/.b Fp parts)
        if p is not None and isinstance(p[0], Fp2):
            return native.g2_in_subgroup(p)
        return native.g1_in_subgroup(p)
    return _ec_mul_raw(p, R) is None


# ---------------------------------------------------------------------------
# Fr
# ---------------------------------------------------------------------------

def fr_to_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    if len(b) != 32:
        raise DecodeError("Fr encoding must be 32 bytes")
    x = int.from_bytes(b, "little")
    if x >= R:
        raise DecodeError("non-canonical Fr encoding")
    return x


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------

_COMPRESSED = 0x80
_INFINITY = 0x40
_SORT = 0x20


def _y_is_lex_largest_fp(y: Fp) -> bool:
    return y.n > P - y.n if y.n != 0 else False


def g1_compress(p) -> bytes:
    if p is None:
        out = bytearray(48)
        out[0] = _COMPRESSED | _INFINITY
        return bytes(out)
    x, y = p
    out = bytearray(x.n.to_bytes(48, "big"))
    out[0] |= _COMPRESSED
    if _y_is_lex_largest_fp(y):
        out[0] |= _SORT
    return bytes(out)


def g1_uncompressed(p) -> bytes:
    if p is None:
        out = bytearray(96)
        out[0] = _INFINITY
        return bytes(out)
    x, y = p
    return x.n.to_bytes(48, "big") + y.n.to_bytes(48, "big")


def _check_flags(b0: int, expect_compressed: bool):
    compressed = bool(b0 & _COMPRESSED)
    if compressed != expect_compressed:
        raise DecodeError("compression flag mismatch")
    return bool(b0 & _INFINITY), bool(b0 & _SORT)


def g1_decompress(b: bytes, subgroup_check: bool = True):
    if len(b) != 48:
        raise DecodeError("G1 compressed encoding must be 48 bytes")
    inf, sort = _check_flags(b[0], True)
    body = bytes([b[0] & 0x1F]) + b[1:]
    xn = int.from_bytes(body, "big")
    if inf:
        if xn != 0 or sort:
            raise DecodeError("non-canonical infinity encoding")
        return None
    if xn >= P:
        raise DecodeError("x out of range")
    x = Fp(xn)
    y = (x.square() * x + Fp(4)).sqrt()
    if y is None:
        raise DecodeError("x not on curve")
    if _y_is_lex_largest_fp(y) != sort:
        y = -y
    pt = (x, y)
    if subgroup_check and not _in_subgroup(pt):
        raise DecodeError("point not in the prime-order subgroup")
    return pt


def g1_from_uncompressed(b: bytes, subgroup_check: bool = True):
    if len(b) != 96:
        raise DecodeError("G1 uncompressed encoding must be 96 bytes")
    inf, sort = _check_flags(b[0], False)
    if inf:
        if any(b[1:]) or (b[0] & ~_INFINITY):
            raise DecodeError("non-canonical infinity encoding")
        return None
    xn = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    yn = int.from_bytes(b[48:], "big")
    if xn >= P or yn >= P:
        raise DecodeError("coordinate out of range")
    pt = (Fp(xn), Fp(yn))
    if not on_curve_g1(pt):
        raise DecodeError("point not on curve")
    if subgroup_check and not _in_subgroup(pt):
        raise DecodeError("point not in the prime-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------

def _y_is_lex_largest_fp2(y: Fp2) -> bool:
    neg = -y
    if y.b.n != neg.b.n:
        return y.b.n > neg.b.n
    return y.a.n > neg.a.n


def g2_compress(p) -> bytes:
    if p is None:
        out = bytearray(96)
        out[0] = _COMPRESSED | _INFINITY
        return bytes(out)
    x, y = p
    out = bytearray(x.b.n.to_bytes(48, "big") + x.a.n.to_bytes(48, "big"))
    out[0] |= _COMPRESSED
    if _y_is_lex_largest_fp2(y):
        out[0] |= _SORT
    return bytes(out)


def g2_uncompressed(p) -> bytes:
    if p is None:
        out = bytearray(192)
        out[0] = _INFINITY
        return bytes(out)
    x, y = p
    return (
        x.b.n.to_bytes(48, "big") + x.a.n.to_bytes(48, "big")
        + y.b.n.to_bytes(48, "big") + y.a.n.to_bytes(48, "big")
    )


def g2_decompress(b: bytes, subgroup_check: bool = True):
    if len(b) != 96:
        raise DecodeError("G2 compressed encoding must be 96 bytes")
    inf, sort = _check_flags(b[0], True)
    c1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    c0 = int.from_bytes(b[48:], "big")
    if inf:
        if c1 != 0 or c0 != 0 or sort:
            raise DecodeError("non-canonical infinity encoding")
        return None
    if c0 >= P or c1 >= P:
        raise DecodeError("x out of range")
    x = Fp2.from_ints(c0, c1)
    y = (x.square() * x + Fp2.from_ints(4, 4)).sqrt()
    if y is None:
        raise DecodeError("x not on curve")
    if _y_is_lex_largest_fp2(y) != sort:
        y = -y
    pt = (x, y)
    if subgroup_check and not _in_subgroup(pt):
        raise DecodeError("point not in the prime-order subgroup")
    return pt


def g2_from_uncompressed(b: bytes, subgroup_check: bool = True):
    if len(b) != 192:
        raise DecodeError("G2 uncompressed encoding must be 192 bytes")
    inf, sort = _check_flags(b[0], False)
    if inf:
        if any(b[1:]) or (b[0] & ~_INFINITY):
            raise DecodeError("non-canonical infinity encoding")
        return None
    xc1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    xc0 = int.from_bytes(b[48:96], "big")
    yc1 = int.from_bytes(b[96:144], "big")
    yc0 = int.from_bytes(b[144:], "big")
    for v in (xc1, xc0, yc1, yc0):
        if v >= P:
            raise DecodeError("coordinate out of range")
    pt = (Fp2.from_ints(xc0, xc1), Fp2.from_ints(yc0, yc1))
    if not on_curve_g2(pt):
        raise DecodeError("point not on curve")
    if subgroup_check and not _in_subgroup(pt):
        raise DecodeError("point not in the prime-order subgroup")
    return pt


# ---------------------------------------------------------------------------
# Aggregates: polynomial / params / witness containers
# (length-prefixed concatenations, mirroring the role of the reference's
# serde_support + bincode round trips, polynomial.rs:692-710)
# ---------------------------------------------------------------------------

def polynomial_to_bytes(coeff_ints) -> bytes:
    out = [struct.pack("<Q", len(coeff_ints))]
    out += [fr_to_bytes(c) for c in coeff_ints]
    return b"".join(out)


def polynomial_from_bytes(b: bytes):
    (n,) = struct.unpack_from("<Q", b, 0)
    if len(b) != 8 + 32 * n:
        raise DecodeError("polynomial length mismatch")
    return [fr_from_bytes(b[8 + 32 * i: 40 + 32 * i]) for i in range(n)]


def params_to_bytes(gs_points, hs_points) -> bytes:
    out = [struct.pack("<Q", len(gs_points))]
    out += [g1_compress(p) for p in gs_points]
    out.append(struct.pack("<Q", len(hs_points)))
    out += [g2_compress(p) for p in hs_points]
    return b"".join(out)


def batch_witness_to_bytes(r_coeff_ints, w_point) -> bytes:
    """KZGBatchWitness { r: Polynomial, w: G1Affine } container codec:
    length-prefixed Fr coefficients of r followed by the 48-byte compressed w.

    This is a PROJECT-CANONICAL format, the functional analog of the
    reference's serde_support (coeff_form.rs:12-13, bincode round-trip
    pattern polynomial.rs:692-710) — it is NOT wire-compatible with the
    Rust bincode output (which carries a leading u64 `degree` field inside
    Polynomial and, for the eval form, a full EvaluationDomain with six
    extra cached fields). The point encodings themselves (48B G1 / 96B G2)
    ARE the standard ZCash format and interoperate."""
    return polynomial_to_bytes(r_coeff_ints) + g1_compress(w_point)


def batch_witness_from_bytes(b: bytes, subgroup_check: bool = True):
    """-> (r_coeff_ints, w_point). Raises DecodeError on malformed input."""
    if len(b) < 8 + 48:
        raise DecodeError("batch witness too short")
    r = polynomial_from_bytes(b[:-48])
    w = g1_decompress(b[-48:], subgroup_check)
    return r, w


def eval_batch_witness_to_bytes(r_eval_ints, w_point) -> bytes:
    """KZGBatchWitnessEvalForm { r: evaluations, w } codec (reference
    eval_form.rs:14-16): identical layout to the coeff-form container — the
    Fr vector is the evaluation vector over the omega-domain."""
    return batch_witness_to_bytes(r_eval_ints, w_point)


def eval_batch_witness_from_bytes(b: bytes, subgroup_check: bool = True):
    return batch_witness_from_bytes(b, subgroup_check)


def params_from_bytes(b: bytes, subgroup_check: bool = False):
    off = 0
    (ng,) = struct.unpack_from("<Q", b, off)
    off += 8
    gs = []
    for _ in range(ng):
        gs.append(g1_decompress(b[off: off + 48], subgroup_check))
        off += 48
    (nh,) = struct.unpack_from("<Q", b, off)
    off += 8
    hs = []
    for _ in range(nh):
        hs.append(g2_decompress(b[off: off + 96], subgroup_check))
        off += 96
    if off != len(b):
        raise DecodeError("params length mismatch")
    return gs, hs
