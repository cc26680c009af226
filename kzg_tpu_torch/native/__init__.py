"""Copy of `kzg_tpu/native/__init__.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package. It builds and loads the same
repo-root `native/kzg_native.cc` (through `make -C native`). One change:
a failed build keeps make's output, so `_require()` (and with it the port's
host setup) fails loudly with the compiler's message.

ctypes bindings for the host-side native BLS12-381 engine.

The Rust reference delegates all heavy host arithmetic to blst (C + asm)
via blstrs (reference Cargo.toml:27, SURVEY.md §2.2); `native/kzg_native.cc`
is this framework's equivalent layer, and this module is its Python face.

The library is built on demand from the committed C++ source with the
baked-in g++ toolchain (no pip/apt dependencies). Everything degrades
gracefully: `available()` returns False when no compiler is present and
callers fall back to the pure-Python oracle.

Interop formats (all bytes objects):
  Fp          48B big-endian
  G1 raw      96B x||y big-endian, plus a separate infinity flag
  G2 raw      192B x.c1||x.c0||y.c1||y.c0
  Fr scalar   32B little-endian standard form (NOT Montgomery)
  Gt          576B: 12 Fp components in tower order (see kzg_native.cc)

Points at the Python level use the oracle convention: None for infinity or
an (x, y) tuple of oracle field elements.
"""

import ctypes
import os
import subprocess
import threading

from ..constants import P
from ..oracle.field import Fp, Fp2

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libkzg_native.so"))

_lib = None
_lib_lock = threading.Lock()
_build_error = None


def _build():
    res = subprocess.run(
        ["make", "-s", "-C", os.path.abspath(_NATIVE_DIR)],
        capture_output=True,
        text=True,
    )
    if res.returncode != 0:
        raise NativeError(
            f"make -C native failed ({res.returncode}):\n{res.stdout}{res.stderr}"
        )


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            # Always invoke make: it is a no-op when the .so is newer than the
            # source, and rebuilds after edits to kzg_native.cc (gating on the
            # .so's existence silently kept loading stale binaries).
            _build()
            lib = ctypes.CDLL(_SO_PATH)
        except Exception as e:  # noqa: BLE001 - any failure means "unavailable"
            _build_error = e
            return None
        lib.kzgn_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def _require():
    """_load() that raises a meaningful NativeError when the engine is
    unavailable (instead of letting wrappers crash on a None lib)."""
    lib = _load()
    if lib is None:
        raise NativeError(f"native engine unavailable: {_build_error!r}")
    return lib


def available() -> bool:
    return _load() is not None


def _buf(b: bytes):
    return ctypes.create_string_buffer(bytes(b), len(b))


# ---------------------------------------------------------------------------
# conversions between oracle points and raw byte layouts
# ---------------------------------------------------------------------------

def _g1_to_raw(p):
    if p is None:
        return b"\x00" * 96, 1
    return p[0].n.to_bytes(48, "big") + p[1].n.to_bytes(48, "big"), 0


def _g1_from_raw(raw: bytes, inf: int):
    if inf:
        return None
    return (Fp(int.from_bytes(raw[:48], "big")), Fp(int.from_bytes(raw[48:], "big")))


def _g2_to_raw(p):
    if p is None:
        return b"\x00" * 192, 1
    x, y = p
    return (
        x.b.n.to_bytes(48, "big")
        + x.a.n.to_bytes(48, "big")
        + y.b.n.to_bytes(48, "big")
        + y.a.n.to_bytes(48, "big")
    ), 0


def _g2_from_raw(raw: bytes, inf: int):
    if inf:
        return None
    xc1 = int.from_bytes(raw[0:48], "big")
    xc0 = int.from_bytes(raw[48:96], "big")
    yc1 = int.from_bytes(raw[96:144], "big")
    yc0 = int.from_bytes(raw[144:192], "big")
    return (Fp2.from_ints(xc0, xc1), Fp2.from_ints(yc0, yc1))


def _scalar_bytes(k: int) -> bytes:
    return int(k).to_bytes(32, "little")


class NativeError(RuntimeError):
    pass


def _check(rc: int, what: str):
    if rc < 0:
        raise NativeError(f"{what} failed with code {rc}")
    return rc


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def g1_msm(points, scalars):
    """MSM over oracle G1 points with integer scalars (host native path)."""
    lib = _require()
    n = len(points)
    pts = bytearray()
    infs = bytearray()
    for p in points:
        raw, inf = _g1_to_raw(p)
        pts += raw
        infs.append(inf)
    sc = b"".join(_scalar_bytes(s) for s in scalars)
    out = ctypes.create_string_buffer(96)
    out_inf = ctypes.c_uint8()
    _check(
        lib.kzgn_g1_msm(bytes(pts), bytes(infs), sc, ctypes.c_long(n), out,
                        ctypes.byref(out_inf)),
        "g1_msm",
    )
    return _g1_from_raw(out.raw, out_inf.value)


def g2_msm(points, scalars):
    lib = _require()
    n = len(points)
    pts = bytearray()
    infs = bytearray()
    for p in points:
        raw, inf = _g2_to_raw(p)
        pts += raw
        infs.append(inf)
    sc = b"".join(_scalar_bytes(s) for s in scalars)
    out = ctypes.create_string_buffer(192)
    out_inf = ctypes.c_uint8()
    _check(
        lib.kzgn_g2_msm(bytes(pts), bytes(infs), sc, ctypes.c_long(n), out,
                        ctypes.byref(out_inf)),
        "g2_msm",
    )
    return _g2_from_raw(out.raw, out_inf.value)


def g1_mul(p, k: int):
    lib = _require()
    raw, inf = _g1_to_raw(p)
    out = ctypes.create_string_buffer(96)
    out_inf = ctypes.c_uint8()
    _check(lib.kzgn_g1_mul(raw, inf, _scalar_bytes(k), out, ctypes.byref(out_inf)),
           "g1_mul")
    return _g1_from_raw(out.raw, out_inf.value)


def g2_mul(p, k: int):
    lib = _require()
    raw, inf = _g2_to_raw(p)
    out = ctypes.create_string_buffer(192)
    out_inf = ctypes.c_uint8()
    _check(lib.kzgn_g2_mul(raw, inf, _scalar_bytes(k), out, ctypes.byref(out_inf)),
           "g2_mul")
    return _g2_from_raw(out.raw, out_inf.value)


def g1_add(a, b):
    lib = _require()
    ra, ia = _g1_to_raw(a)
    rb, ib = _g1_to_raw(b)
    out = ctypes.create_string_buffer(96)
    out_inf = ctypes.c_uint8()
    _check(lib.kzgn_g1_add(ra, ia, rb, ib, out, ctypes.byref(out_inf)), "g1_add")
    return _g1_from_raw(out.raw, out_inf.value)


def g2_add(a, b):
    lib = _require()
    ra, ia = _g2_to_raw(a)
    rb, ib = _g2_to_raw(b)
    out = ctypes.create_string_buffer(192)
    out_inf = ctypes.c_uint8()
    _check(lib.kzgn_g2_add(ra, ia, rb, ib, out, ctypes.byref(out_inf)), "g2_add")
    return _g2_from_raw(out.raw, out_inf.value)


def g1_powers(base, s: int, n: int):
    """[base * s^i for i in range(n)] — native SRS ladder (lib.rs:38-55)."""
    lib = _require()
    raw, inf = _g1_to_raw(base)
    if inf:
        raise NativeError("g1_powers base must not be infinity")
    out = ctypes.create_string_buffer(96 * n)
    _check(lib.kzgn_g1_powers(raw, _scalar_bytes(s), ctypes.c_long(n), out),
           "g1_powers")
    return [_g1_from_raw(out.raw[i * 96:(i + 1) * 96], 0) for i in range(n)]


def g2_powers(base, s: int, n: int):
    lib = _require()
    raw, inf = _g2_to_raw(base)
    if inf:
        raise NativeError("g2_powers base must not be infinity")
    out = ctypes.create_string_buffer(192 * n)
    _check(lib.kzgn_g2_powers(raw, _scalar_bytes(s), ctypes.c_long(n), out),
           "g2_powers")
    return [_g2_from_raw(out.raw[i * 192:(i + 1) * 192], 0) for i in range(n)]


def g1_compress(p) -> bytes:
    lib = _require()
    raw, inf = _g1_to_raw(p)
    out = ctypes.create_string_buffer(48)
    _check(lib.kzgn_g1_compress(raw, inf, out), "g1_compress")
    return out.raw


def g1_decompress(b: bytes, subgroup_check: bool = True):
    lib = _require()
    out = ctypes.create_string_buffer(96)
    out_inf = ctypes.c_uint8()
    _check(lib.kzgn_g1_decompress(bytes(b), out, ctypes.byref(out_inf),
                                  1 if subgroup_check else 0),
           "g1_decompress")
    return _g1_from_raw(out.raw, out_inf.value)


def g2_compress(p) -> bytes:
    lib = _require()
    raw, inf = _g2_to_raw(p)
    out = ctypes.create_string_buffer(96)
    _check(lib.kzgn_g2_compress(raw, inf, out), "g2_compress")
    return out.raw


def g2_decompress(b: bytes, subgroup_check: bool = True):
    lib = _require()
    out = ctypes.create_string_buffer(192)
    out_inf = ctypes.c_uint8()
    _check(lib.kzgn_g2_decompress(bytes(b), out, ctypes.byref(out_inf),
                                  1 if subgroup_check else 0),
           "g2_decompress")
    return _g2_from_raw(out.raw, out_inf.value)


def pairing_check(pairs) -> bool:
    """True iff prod e(P_i, Q_i) == 1 (shares one final exponentiation)."""
    lib = _require()
    n = len(pairs)
    g1s = bytearray()
    g1infs = bytearray()
    g2s = bytearray()
    g2infs = bytearray()
    for p, q in pairs:
        raw1, i1 = _g1_to_raw(p)
        raw2, i2 = _g2_to_raw(q)
        g1s += raw1
        g1infs.append(i1)
        g2s += raw2
        g2infs.append(i2)
    rc = _check(
        lib.kzgn_pairing_check(bytes(g1s), bytes(g1infs), bytes(g2s), bytes(g2infs),
                               ctypes.c_long(n)),
        "pairing_check",
    )
    return rc == 1


def pairing(p, q):
    """Full Gt value as an oracle Fp12 (for equality tests vs the oracle)."""
    from ..oracle.field import Fp6, Fp12

    lib = _require()
    raw1, i1 = _g1_to_raw(p)
    raw2, i2 = _g2_to_raw(q)
    out = ctypes.create_string_buffer(576)
    _check(lib.kzgn_pairing(raw1, i1, raw2, i2, out), "pairing")
    comps = [int.from_bytes(out.raw[i * 48:(i + 1) * 48], "big") for i in range(12)]

    def fp2(i):
        return Fp2(Fp(comps[i]), Fp(comps[i + 1]))

    c0 = Fp6(fp2(0), fp2(2), fp2(4))
    c1 = Fp6(fp2(6), fp2(8), fp2(10))
    return Fp12(c0, c1)


def g1_on_curve(p) -> bool:
    lib = _require()
    raw, inf = _g1_to_raw(p)
    return _check(lib.kzgn_g1_on_curve(raw, inf), "g1_on_curve") == 1


def g2_on_curve(p) -> bool:
    lib = _require()
    raw, inf = _g2_to_raw(p)
    return _check(lib.kzgn_g2_on_curve(raw, inf), "g2_on_curve") == 1


def g1_in_subgroup(p) -> bool:
    lib = _require()
    raw, inf = _g1_to_raw(p)
    return _check(lib.kzgn_g1_in_subgroup(raw, inf), "g1_in_subgroup") == 1


def g2_in_subgroup(p) -> bool:
    lib = _require()
    raw, inf = _g2_to_raw(p)
    return _check(lib.kzgn_g2_in_subgroup(raw, inf), "g2_in_subgroup") == 1
