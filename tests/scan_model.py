"""The schedules of `csrc/scan.cuh` on Python integers: `simulate_scan`
(field_scan) and `simulate_horner` (fr_horner) follow the kernels' own
index arithmetic (tiles, each thread's run, the warp's shuffles with their
lane guards, the warps' carries through shared memory, the ragged last
tile, reverse, the column, total and pair modes (a pair: each row forward
and reversed, exclusive), the carry in at position n) and
the wrappers' chain of tile passes (`cuda_field._scan_tiles`,
`poly.horner._horner_tiles`). Values are plain residues mod the field's
modulus: the Montgomery form is a ring isomorphism, so a schedule that is
right on residues is right on the kernel's words. The tile constants come
from the CUDA header itself.
"""

import re
from pathlib import Path

from kzg_tpu_torch import kernels

_HEADER = (Path(kernels.CSRC) / "scan.cuh").read_text()


def header_constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _HEADER).group(1))


THREADS = header_constant("kScanThreads")
RUN = header_constant("kScanRun")
TILE = THREADS * RUN
WARPS = THREADS // 32
REVERSE, PAIR, EXCLUSIVE = (header_constant(k) for k in ("kScanReverse", "kScanPair",
                                                          "kScanExclusive"))

ADD, MUL = "add", "mul"


def _op(op, mod):
    if op == MUL:
        return (lambda a, b: a * b % mod), 1
    return (lambda a, b: (a + b) % mod), 0


def _shfl_up(vals, d):
    """__shfl_up_sync: lane l reads lane l - d; lanes below d keep their own."""
    return [vals[lane - d] if lane >= d else vals[lane] for lane in range(32)]


def _shfl_down(vals, d):
    return [vals[lane + d] if lane + d < 32 else vals[lane] for lane in range(32)]


def _scan_tile_pass(src, n, rows, flags, op, mod, out_mode, carry=None):
    """One launch of `scan_kernel`: src(row, p) the element of input row
    `row` at physical p. Returns {row: list of n} (out_mode) or {row: list
    of tiles} (totals), by the grid's rows (a pair: 2 a row of input)."""
    f, ident = _op(op, mod)
    tiles = -(-n // TILE)
    half = rows // 2 if flags & PAIR else rows
    res = {}
    for row in range(rows):
        second = row >= half
        irow = row - half if second else row
        reverse = second if flags & PAIR else bool(flags & REVERSE)
        out = [None] * n
        totals = []
        for g in range(tiles):
            base = g * TILE
            tile = []
            for j in range(TILE):
                p = base + j
                tile.append(src(irow, n - 1 - p if reverse else p) if p < n else ident)
            acc = [None] * THREADS
            for t in range(THREADS):
                a = tile[t * RUN]
                for k in range(1, RUN):
                    a = f(a, tile[t * RUN + k])
                    tile[t * RUN + k] = a
                acc[t] = a
            s = []  # inclusive across each warp, by shuffles
            for w in range(WARPS):
                sw = acc[32 * w:32 * w + 32]
                d = 1
                while d < 32:
                    o = _shfl_up(sw, d)
                    sw = [f(o[lane], sw[lane]) if lane >= d else sw[lane] for lane in range(32)]
                    d <<= 1
                s.append(sw)
            warp_tot = [sw[31] for sw in s]
            pres = []
            for w in range(WARPS):
                pre = carry[row][g - 1] if (carry is not None and g > 0) else ident
                for v in warp_tot[:w]:
                    pre = f(pre, v)
                pres.append(pre)
            if not out_mode:
                totals.append(f(pres[WARPS - 1], s[WARPS - 1][31]))
                continue
            for t in range(THREADS):
                w, lane = divmod(t, 32)
                below = _shfl_up(s[w], 1)[lane]
                e = pres[w] if lane == 0 else f(pres[w], below)
                if flags & EXCLUSIVE:
                    for k in range(RUN - 1, 0, -1):
                        tile[t * RUN + k] = f(e, tile[t * RUN + k - 1])
                    tile[t * RUN] = e
                else:
                    for k in range(RUN):
                        tile[t * RUN + k] = f(e, tile[t * RUN + k])
            for j in range(TILE):
                p = base + j
                if p < n:
                    out[n - 1 - p if reverse else p] = tile[j]
        res[row] = out if out_mode else totals
    return res


def _scan_tiles(src, n, rows, flags, op, mod, total):
    """`cuda_field._scan_tiles` on residues; returns (result, passes)."""
    tiles = -(-n // TILE)
    if tiles == 1:
        r = _scan_tile_pass(src, n, rows, flags, op, mod, not total)
        return ({row: v[0] for row, v in r.items()} if total else r), 1
    tot = _scan_tile_pass(src, n, rows, flags, op, mod, False)
    tsrc = lambda row, p: tot[row][p]  # noqa: E731
    if total:
        r, passes = _scan_tiles(tsrc, tiles, rows, 0, op, mod, True)
        return r, passes + 1
    carry, passes = _scan_tiles(tsrc, tiles, rows, 0, op, mod, False)
    out = _scan_tile_pass(src, n, rows, flags, op, mod, True, carry=carry)
    return out, passes + 2


def simulate_scan(values, op, mod, reverse=False, mode="array", n=None):
    """field_scan's schedule on residues. values: a list of rows (lists;
    mode "column": one value a row, repeated n times). Returns (a list a
    row, or one value a row for "total", and for "pair" the exclusive
    prefixes of the rows then their exclusive suffixes; the launches it
    took)."""
    rows = len(values)
    flags = REVERSE if reverse else 0
    if mode == "column":
        src = lambda row, p: values[row]  # noqa: E731
    else:
        n = len(values[0])
        src = lambda row, p: values[row][p]  # noqa: E731
    if mode == "pair":
        rows, flags = 2 * rows, PAIR | EXCLUSIVE
    res, passes = _scan_tiles(src, n, rows, flags, op, mod, mode == "total")
    return [res[row] for row in range(rows)], passes


def _horner_tile_pass(coef, n, k, xs, cin, mod, totals_mode, tile_carry=None):
    """One launch of `horner_kernel`: coef(row, p) for p < n, cin[row] at
    p = n when given, zero above. Returns totals {row: [tiles]} and xpow
    {row: x^TILE} (totals_mode) or h {row: {p: h_p}} for 0 <= p < n."""
    hs = lambda f, x, c: (f + x * c) % mod  # noqa: E731
    length = n + (cin is not None)
    tiles = -(-length // TILE)
    totals, xpow, out = {}, {}, {}
    for row in range(k):
        x = xs[row]
        xm = x
        m = 1
        while m < RUN:
            xm = xm * xm % mod
            m <<= 1
        totals[row], out[row] = [], {}
        for g in range(tiles):
            base = g * TILE
            tile = []
            for j in range(TILE):
                p = base + j
                v = 0
                if p < n:
                    v = coef(row, p)
                elif p == n and cin is not None:
                    v = cin[row]
                tile.append(v)
            runs = []
            for t in range(THREADS):
                r0 = t * RUN
                v = tile[r0 + RUN - 1]
                for j in range(RUN - 2, -1, -1):
                    v = hs(tile[r0 + j], x, v)
                runs.append(v)

            def warp_scan(vals):
                s, xd, d = list(vals), xm, 1
                while d < 32:
                    o = _shfl_down(s, d)
                    s = [hs(s[lane], xd, o[lane]) if lane + d < 32 else s[lane]
                         for lane in range(32)]
                    xd = xd * xd % mod
                    d <<= 1
                return s, xd

            scans = [warp_scan(runs[32 * w:32 * w + 32]) for w in range(WARPS)]
            x32m = scans[0][1]
            warp_val = [sw[0] for sw, _ in scans]
            carries = []
            for warp in range(WARPS):
                c = 0
                if not totals_mode and g < tiles - 1:
                    c = tile_carry[row][g]
                for w in range(WARPS - 1, warp, -1):
                    c = hs(warp_val[w], x32m, c)
                carries.append(c)
            if totals_mode:
                totals[row].append(hs(scans[0][0][0], x32m, carries[0]))
                if g == 0:
                    xt, w = x32m, 1
                    while w < WARPS:
                        xt = xt * xt % mod
                        w <<= 1
                    xpow[row] = xt
                continue
            for w in range(WARPS):
                c = carries[w]
                vals = runs[32 * w:32 * w + 32]
                vals[31] = hs(vals[31], xm, c)
                s, _ = warp_scan(vals)
                above = _shfl_down(s, 1)
                for lane in range(32):
                    t = 32 * w + lane
                    h = c if lane == 31 else above[lane]
                    for j in range(RUN - 1, -1, -1):
                        h = hs(tile[t * RUN + j], x, h)
                        tile[t * RUN + j] = h
            for j in range(TILE):
                p = base + j
                if p < n:
                    out[row][p] = tile[j]
    return (totals, xpow) if totals_mode else out


def _horner_tiles(coef, n, k, xs, cin, mod, rem_only):
    """`poly.horner._horner_tiles` on residues: (q rows or None, rem, passes)."""
    tiles = -(-(n + (cin is not None)) // TILE)
    if tiles == 1:
        if rem_only:
            totals, _ = _horner_tile_pass(coef, n, k, xs, cin, mod, True)
            return None, [totals[row][0] for row in range(k)], 1
        h = _horner_tile_pass(coef, n, k, xs, cin, mod, False)
        return ([[h[row][p] for p in range(1, n)] for row in range(k)],
                [h[row][0] for row in range(k)], 1)
    totals, xpow = _horner_tile_pass(coef, n, k, xs, cin, mod, True)
    ys = [xpow[row] for row in range(k)]
    tile_q, rem, passes = _horner_tiles(lambda row, p: totals[row][p], tiles, k, ys, None, mod,
                                        rem_only)
    if rem_only:
        return None, rem, passes + 1
    h = _horner_tile_pass(coef, n, k, xs, cin, mod, False, tile_carry=tile_q)
    return [[h[row][p] for p in range(1, n)] for row in range(k)], rem, passes + 2


def simulate_horner(f, xs, mod, carry=None, rem_only=False):
    """fr_horner's schedule on residues: f a list of coefficients, one
    polynomial for every point. Returns (q: a list a point, or None; rem:
    one value a point; the launches it took)."""
    return _horner_tiles(lambda row, p: f[p], len(f), len(xs), xs, carry, mod, rem_only)
