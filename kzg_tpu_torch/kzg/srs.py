"""Trusted setup: the SRS power ladders g^(s^i), h^(s^i) (port of
`kzg_tpu/kzg/srs.py`).

Params hold affine batches, the form the MSM consumes: gs = (x, y, inf)
with (12, n) words, hs = (x, y, inf) with (12, 2, n) Fp2 words. `save` and
`load` use the JAX package's `.npz` format (16-bit limbs in uint32,
`srs.py:49-62`), so an SRS saved by either package loads into the other.

Two engines build the SRS, chosen by `config.setup_engine`
(`host_engine_preferred`): "auto" takes the device route for a card and the
host engine for the CPU, "host" / "device" force one.

Device route (`setup_device`), where the reference runs a serial chain of
scalar multiplications (lib.rs:38-55):

  1. the powers s^0 .. s^(n-1) by a log-depth prefix product over Fr (K1);
  2. one fixed-base window table per group, T[w][d] = (d 2^(c w)) G
     (`fixed_base_tables`): it depends on the generators only, is read from
     the repo's `.srs_cache/fixed_base_c8_w32.npz` (written by either
     package, validated by digest and by sampled entries against the host
     engine) and rebuilt by a doubling chain and a prefix point scan only
     when that fails;
  3. every SRS element is then W gathers and point adds over all n lanes
     (`_ladder_from_table`, K2 add), and one batched `to_affine`.

Host route: the native engine's power ladder, cut into one chunk per CPU
core: each chunk starts from base * s^offset and runs on its own thread
(ctypes releases the interpreter lock), which yields the same affine points
as one serial ladder.
"""

import hashlib
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..config import get_config, resolve_device
from ..constants import P, R
from ..curve import G1, G2, g1_generator_device, g1_to_device, g2_generator_device, g2_to_device
from ..fields import FP, FR
from ..fields.limb import pack16, unpack16
from ..msm.pippenger import _digits


def _to_limbs16(words: torch.Tensor) -> np.ndarray:
    """(12, ...) packed words -> the JAX package's (24, ...) uint32 limbs."""
    return unpack16(words.cpu()).numpy().astype(np.uint32)


def _from_limbs16(limbs: np.ndarray, device) -> torch.Tensor:
    return pack16(torch.from_numpy(limbs.astype(np.int64))).to(resolve_device(device))


def _mask(flags, device) -> torch.Tensor:
    """A bool infinity mask on `device` (None: the configured default)."""
    return torch.from_numpy(np.asarray(flags, dtype=bool)).to(resolve_device(device))


@dataclass
class KZGParams:
    """SRS: gs = G1 affine batch of g^(s^i), i < n; hs = the same over G2
    (reference KZGParams, lib.rs:14-19)."""

    gs: tuple
    hs: tuple
    n: int

    def save(self, path: str):
        np.savez(
            path,
            g_x=_to_limbs16(self.gs[0]), g_y=_to_limbs16(self.gs[1]),
            g_i=self.gs[2].cpu().numpy(),
            h_x=_to_limbs16(self.hs[0]), h_y=_to_limbs16(self.hs[1]),
            h_i=self.hs[2].cpu().numpy(),
            n=self.n,
        )

    @classmethod
    def from_numpy(cls, gs_np, hs_np, n: int, device=None) -> "KZGParams":
        """From the JAX package's arrays: gs_np = ((24, n) x, (24, n) y,
        (n,) inf) and hs_np = ((24, 2, n) x, (24, 2, n) y, (n,) inf), limbs
        as uint32 16-bit values. device=None: the configured default."""
        gs = (_from_limbs16(np.asarray(gs_np[0]), device),
              _from_limbs16(np.asarray(gs_np[1]), device),
              _mask(gs_np[2], device))
        hs = (_from_limbs16(np.asarray(hs_np[0]), device),
              _from_limbs16(np.asarray(hs_np[1]), device),
              _mask(hs_np[2], device))
        return cls(gs=gs, hs=hs, n=int(n))

    @classmethod
    def load(cls, path: str, device=None) -> "KZGParams":
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            gs = tuple(z[k] for k in ("g_x", "g_y", "g_i"))
            hs = tuple(z[k] for k in ("h_x", "h_y", "h_i"))
            n = int(z["n"])
        return cls.from_numpy(gs, hs, n, device)


def _powers_parallel(mul, powers, base, s: int, n: int):
    """[base * s^i for i < n] as one engine power ladder per chunk, the
    chunks on a thread pool."""
    workers = max(1, min(os.cpu_count() or 1, n // 256 or 1))
    step = -(-n // workers)
    # chunk bases serially: the first engine call initialises its tables
    starts = list(range(0, n, step))
    bases = [mul(base, pow(s, off, R)) for off in starts]
    with ThreadPoolExecutor(max_workers=len(starts)) as pool:
        futs = [pool.submit(powers, b, s, min(step, n - off)) for b, off in zip(bases, starts)]
        return [p for f in futs for p in f.result()]


def _setup_host(s: int, num_coeffs: int, device=None) -> KZGParams:
    from .. import native
    from ..oracle import g1_generator, g2_generator

    s %= R
    gpts = _powers_parallel(native.g1_mul, native.g1_powers, g1_generator(), s, num_coeffs)
    hpts = _powers_parallel(native.g2_mul, native.g2_powers, g2_generator(), s, num_coeffs)
    gx, gy, _ = g1_to_device(gpts, device)
    hx, hy, _ = g2_to_device(hpts, device)
    ginf = _mask([p is None for p in gpts], device)
    hinf = _mask([p is None for p in hpts], device)
    return KZGParams(gs=(gx, gy, ginf), hs=(hx, hy, hinf), n=num_coeffs)


# ---- the fixed-base tables ------------------------------------------------------------

def _fb_window() -> int:
    return get_config().fixed_base_window


def _fixed_base_table(curve, gen_point, c: int, w_count: int):
    """T[w][d] = (d << (c w)) G as a Jacobian batch of shape (w_count, 2^c),
    from the generator as a batch-(1,) point. The bases 2^(c w) G come from
    one chain of c w_count doublings on a single lane; each row [B, 2B, ..,
    (2^c - 1) B] is a log-depth prefix point scan of a constant-B batch
    (`kzg_tpu/kzg/srs.py:65-104`), with an infinity column in front."""
    b = 1 << c
    dev = gen_point[0].device
    bases = []
    pt = gen_point
    for _ in range(w_count):
        bases.append(pt)
        for _ in range(c):
            pt = curve.dbl(pt)
    base_batch = tuple(torch.cat([p[i] for p in bases], dim=-1) for i in range(3))
    n = b - 1
    acc = tuple(t[..., None].expand(t.shape + (n,)).contiguous() for t in base_batch)
    idx = torch.arange(n, device=dev)
    for r in range(max(1, (n - 1).bit_length())):
        step = 1 << r
        shifted = tuple(torch.roll(t, step, dims=-1) for t in acc)
        acc = curve.select(idx >= step, curve.add(acc, shifted), acc)
    inf_col = curve.infinity((w_count, 1), dev)
    return tuple(torch.cat([ic, t], dim=-1) for ic, t in zip(inf_col, acc))


def _ladder_from_table(curve, table, digits):
    """The points sum_w T[w][digits[w, i]] for every lane i: W gathers and
    adds. table: Jacobian (w_count, 2^c) batch; digits: (W, n) integers."""
    acc = curve.infinity((digits.shape[-1],), digits.device)
    for w in range(digits.shape[0]):
        d = digits[w].to(torch.int64)
        acc = curve.add(acc, tuple(t[..., w, :].index_select(-1, d) for t in table))
    return acc


_TABLE_CACHE = {}


def _table_cache_path(c: int, w_count: int) -> str:
    d = get_config().srs_cache_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".srs_cache")
    return os.path.join(d, f"fixed_base_c{c}_w{w_count}.npz")


def _mont_point_int(limbs) -> int:
    """Host-side Montgomery Fp 16-bit limbs (24,) -> the standard integer."""
    v = 0
    for i, limb in enumerate(limbs):
        v |= int(limb) << (16 * i)
    return v * pow(FP.mont_r, -1, P) % P


def _validate_tables(t1, t2, c: int, w_count: int) -> bool:
    """Integrity check of fixed-base tables in the `.npz` layout (numpy,
    16-bit limbs: t1 3 x (24, w_count, 2^c), t2 3 x (24, 2, w_count, 2^c)).
    Every SRS derives from them, so a stale or corrupt blob would give a
    wrong SRS without a word. Checks shapes, the d == 0 infinity column, and
    sampled entries T[w][d] == (d << c w) G against the host engine (the
    oracle where it is missing): host integer math only."""
    from .. import native
    from ..oracle import ec_mul, g1_generator, g2_generator
    from ..oracle.field import Fp as OFp, Fp2 as OFp2

    b = 1 << c
    try:
        t1 = tuple(np.asarray(t) for t in t1)
        t2 = tuple(np.asarray(t) for t in t2)
        if any(t.shape != (2 * FP.W, w_count, b) for t in t1):
            return False
        if any(t.shape != (2 * FP.W, 2, w_count, b) for t in t2):
            return False
        if t1[2][:, :, 0].any() or t2[2][:, :, :, 0].any():
            return False
        if (~t1[2][:, :, 1:].any(axis=0)).any():
            return False

        def affine(x, y, z):
            zi = z.inv()
            zi2 = zi.square()
            return (x * zi2, y * (zi2 * zi))

        def g1_entry(w, d):
            return affine(*(OFp(_mont_point_int(t[:, w, d])) for t in t1))

        def g2_entry(w, d):
            return affine(*(OFp2(OFp(_mont_point_int(t[:, 0, w, d])),
                                 OFp(_mont_point_int(t[:, 1, w, d]))) for t in t2))

        if native.available():
            mul1 = lambda k: native.g1_mul(g1_generator(), k)  # noqa: E731
            mul2 = lambda k: native.g2_mul(g2_generator(), k)  # noqa: E731
        else:
            mul1 = lambda k: ec_mul(g1_generator(), k)  # noqa: E731
            mul2 = lambda k: ec_mul(g2_generator(), k)  # noqa: E731
        for w, d in {(0, 1), (w_count - 1, b - 1), (w_count // 2, min(3, b - 1))}:
            k = (d << (c * w)) % R
            if g1_entry(w, d) != mul1(k) or g2_entry(w, d) != mul2(k):
                return False
        return True
    except Exception:  # noqa: BLE001 - a malformed blob is an invalid one
        return False


def _tables_digest(t1, t2) -> str:
    """sha256 over the six arrays of the `.npz` layout, as the JAX package
    computes it, so either package accepts a blob the other wrote."""
    h = hashlib.sha256()
    for t in (*t1, *t2):
        h.update(np.ascontiguousarray(np.asarray(t)).tobytes())
    return h.hexdigest()


def tables_from_numpy(t1_np, t2_np, device=None):
    """The JAX package's fixed-base tables (numpy or array-likes, 16-bit
    limbs in uint32, as its `fixed_base_tables` returns them and as the
    `.npz` holds them) as the port's packed Jacobian tables on `device`:
    t1 3 x (12, w_count, 2^c), t2 3 x (12, 2, w_count, 2^c) int32."""
    return (tuple(_from_limbs16(np.asarray(t), device) for t in t1_np),
            tuple(_from_limbs16(np.asarray(t), device) for t in t2_np))


def fixed_base_tables(c: int, w_count: int, device=None):
    """The G1 / G2 fixed-base window tables T[w][d] = (d << c w) G on
    `device`, as packed Jacobian batches (`tables_from_numpy`).

    They depend on the generators only, so they are computed once and kept
    on disk (`_table_cache_path`, ~7 MB at c = 8) in the JAX package's
    layout. A loaded blob must match its digest and pass `_validate_tables`;
    one that does not is rebuilt on `device` and rewritten, with a warning."""
    dev = resolve_device(device)
    key = (c, w_count, dev)
    if key in _TABLE_CACHE:
        return _TABLE_CACHE[key]
    path = _table_cache_path(c, w_count)
    tables = None
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                t1_np = tuple(z[f"t1_{i}"] for i in range(3))
                t2_np = tuple(z[f"t2_{i}"] for i in range(3))
                digest = str(z["digest"]) if "digest" in z.files else None
            if ((digest is None or digest == _tables_digest(t1_np, t2_np))
                    and _validate_tables(t1_np, t2_np, c, w_count)):
                tables = tables_from_numpy(t1_np, t2_np, dev)
        except Exception:  # noqa: BLE001 - an unreadable blob is rebuilt
            tables = None
        if tables is None:
            warnings.warn(
                f"fixed-base table cache {path} failed integrity validation; rebuilding",
                stacklevel=2)
    if tables is None:
        tables = (_fixed_base_table(G1, g1_generator_device(1, dev), c, w_count),
                  _fixed_base_table(G2, g2_generator_device(1, dev), c, w_count))
        t1_np = tuple(_to_limbs16(t) for t in tables[0])
        t2_np = tuple(_to_limbs16(t) for t in tables[1])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(
            path,
            **{f"t1_{i}": t for i, t in enumerate(t1_np)},
            **{f"t2_{i}": t for i, t in enumerate(t2_np)},
            digest=_tables_digest(t1_np, t2_np),
        )
    _TABLE_CACHE[key] = tables
    return tables


# ---- the device route -------------------------------------------------------------------

def _setup_digits(n: int, c: int, s_mont: torch.Tensor, base_mont=None) -> torch.Tensor:
    """(W, n) window digits of base * s^0 .. base * s^(n-1) (base = 1 when
    None), from s as an (8, 1) Montgomery column: the running product of the
    column (`field_scan`) and `msm.pippenger._digits`."""
    pw = FR.powers(s_mont[:, 0], n)  # s^1 .. s^n
    powers = torch.cat([FR.one((1,), s_mont.device), pw[:, : n - 1]], dim=1)
    if base_mont is not None:
        powers = FR.mul(powers, base_mont)
    return _digits(FR.from_mont(powers), c)


def _ladders(c: int, digits: torch.Tensor):
    """Both fixed-base ladders for a (W, n) digit array, in affine form:
    shared by `setup_device` and the Lagrange SRS from a secret."""
    t1, t2 = fixed_base_tables(c, digits.shape[0], digits.device)
    return (G1.to_affine(_ladder_from_table(G1, t1, digits)),
            G2.to_affine(_ladder_from_table(G2, t2, digits)))


def setup_device(s: int, num_coeffs: int, g2_count: int | None = None,
                 device=None) -> KZGParams:
    """The SRS by the device route (module docstring), on `device` (None:
    the configured default). On a CPU device every step runs its plain
    version.

    g2_count limits how many G2 powers h^(s^i) are built (default: all
    num_coeffs, reference lib.rs:48-52). Single openings need only hs[0..1]
    (`verify_eval`): pass g2_count=2; a batched verification at k points
    needs g2_count >= k + 1.

    Above 2^msm_chunk_log points the G1 ladder is built in chunks of that
    many powers (digits, gathers and adds per chunk, each chunk starting
    from s^offset), so the peak memory of the digits and the Jacobian
    intermediates is flat in n."""
    dev = resolve_device(device)
    s %= R
    s_mont = torch.from_numpy(FR.encode([s])).to(dev)
    c = _fb_window()
    if g2_count is None:
        g2_count = num_coeffs
    chunk = 1 << get_config().msm_chunk_log
    if num_coeffs <= chunk and g2_count == num_coeffs:
        gs, hs = _ladders(c, _setup_digits(num_coeffs, c, s_mont))
        return KZGParams(gs=gs, hs=hs, n=num_coeffs)
    t1, t2 = fixed_base_tables(c, -(-32 * FR.W // c), dev)
    parts = []
    for off in range(0, num_coeffs, chunk):
        base = torch.from_numpy(FR.encode([pow(s, off, R)])).to(dev)
        digits = _setup_digits(min(chunk, num_coeffs - off), c, s_mont, base)
        parts.append(G1.to_affine(_ladder_from_table(G1, t1, digits)))
    gs = tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(3))
    hs = G2.to_affine(_ladder_from_table(G2, t2, _setup_digits(g2_count, c, s_mont)))
    return KZGParams(gs=gs, hs=hs, n=num_coeffs)


def host_engine_preferred(device=None) -> bool:
    """The engine `setup` and `compute_lagrange_basis_from_secret` take for
    `device` (None: the configured default), from config.setup_engine:
    "device" and "host" force a route ("host" raises where the native engine
    is missing); "auto" takes the device route for a card, and for the CPU
    the host engine where it is available (the device route on the plain
    versions costs ~60 ms a point add whatever the batch)."""
    from .. import native

    engine = get_config().setup_engine
    if engine == "device":
        return False
    if engine == "host":
        if not native.available():
            raise native.NativeError(
                "setup_engine='host' but the native engine is unavailable")
        return True
    return resolve_device(device).type == "cpu" and native.available()


def setup(s: int, num_coeffs: int, device=None) -> KZGParams:
    """Build an SRS for polynomials with up to num_coeffs coefficients from
    the secret s (reference setup(), lib.rs:38-55), on `device` (None: the
    configured default device, the card), by the engine
    `host_engine_preferred` picks."""
    if host_engine_preferred(device):
        return _setup_host(s, num_coeffs, device)
    return setup_device(s, num_coeffs, device=device)


def csprng_setup(num_coeffs: int, device=None) -> KZGParams:
    """Random setup from OS entropy (reference csprng_setup, lib.rs:60-64)."""
    s = int.from_bytes(os.urandom(48), "little") % R
    return setup(s, num_coeffs, device)

