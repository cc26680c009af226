"""The one-thread Montgomery arithmetic of `kzg_tpu_torch/csrc/field.cuh`,
emulated instruction by instruction on numpy words (imported by
`tests/test_torch_field_body.py`).

Each method of `Body` runs the header's function of the same name over many
lanes at once: an operand is a list of N uint64 arrays, word l of every
lane, each below 2^32. The PTX carry flag is an array beside them (`cf`),
set by the `.cc` forms and read by the `c` forms, as on the card. The
model also checks what the header's comments claim: no chain drops a
carry. A chain that starts afresh (`mad.lo.cc`, `add.cc`, `sub.cc`) while
the flag of an earlier chain is still unread, and the last word of a chain
written without a carry out (`madc.hi`, `addc`), assert that the carry they
drop is 0 in every lane; so do the funnel shifts that double S.
"""

import numpy as np

MASK32 = (1 << 32) - 1


class Body:
    """The functions of field.cuh for a modulus of `n` 32-bit words."""

    def __init__(self, mod, n):
        assert n % 2 == 0 and mod < 1 << (32 * n - 1)
        self.n = n
        self.mod = mod
        self.p = [np.uint64((mod >> (32 * j)) & MASK32) for j in range(n)]
        self.nprime = np.uint64((-pow(mod, -1, 1 << 32)) % (1 << 32))
        self.cf = None       # the carry flag, one bit a lane
        self.pending = False  # set by a .cc form, cleared when a c form reads it

    # ---- the PTX instructions ---------------------------------------------

    def _set(self, r):
        self.cf = r >> np.uint64(32)
        self.pending = True
        return r & np.uint64(MASK32)

    def _fresh(self):
        """A chain starts: the flag of the one before must be spent or 0."""
        if self.pending:
            assert not self.cf.any(), "a chain's carry out was dropped"
        self.pending = False

    def _read(self):
        assert self.cf is not None, "a c form read a flag no chain set"
        self.pending = False
        return self.cf

    def add_cc(self, a, b):
        self._fresh()
        return self._set(a + b)

    def addc_cc(self, a, b):
        return self._set(a + b + self._read())

    def addc(self, a, b, wraps=False):
        """addc.u32; `wraps` where the sum is meant to lose its carry (a
        borrow undone by adding p back)."""
        r = a + b + self._read()
        assert wraps or not (r >> np.uint64(32)).any(), "addc carried out"
        return r & np.uint64(MASK32)

    def sub_cc(self, a, b):
        self._fresh()
        return self._sub(a, b, np.uint64(0))

    def subc_cc(self, a, b):
        return self._sub(a, b, self._read())

    def _sub(self, a, b, borrow):
        r = (a - b - borrow) & np.uint64((1 << 64) - 1)  # wraps like the card's words
        self.cf = (a < b + borrow).astype(np.uint64)
        self.pending = True
        return r & np.uint64(MASK32)

    def subc(self, a, b):
        borrow = self._read()
        return (a - b - borrow) & np.uint64(MASK32)

    @staticmethod
    def _lo(a, b):
        return (a * b) & np.uint64(MASK32)

    @staticmethod
    def _hi(a, b):
        return (a * b) >> np.uint64(32)

    def mad_lo_cc(self, a, b, c):
        self._fresh()
        return self._set(self._lo(a, b) + c)

    def madc_lo_cc(self, a, b, c):
        return self._set(self._lo(a, b) + c + self._read())

    def madc_hi_cc(self, a, b, c):
        return self._set(self._hi(a, b) + c + self._read())

    def madc_hi(self, a, b, c):
        r = self._hi(a, b) + c + self._read()
        assert not (r >> np.uint64(32)).any(), "madc.hi carried out"
        return r

    @staticmethod
    def funnelshift_l(lo, hi):
        return ((hi << np.uint64(1)) | (lo >> np.uint64(31))) & np.uint64(MASK32)

    # ---- the rows ------------------------------------------------------------

    def row_mul(self, acc, x, b, off=0):
        for j in range(0, self.n, 2):
            acc[j] = self._lo(x[off + j], b)
            acc[j + 1] = self._hi(x[off + j], b)

    def row_mad(self, acc, x, b, off=0):
        acc[0] = self.mad_lo_cc(x[off], b, acc[0])
        acc[1] = self.madc_hi_cc(x[off], b, acc[1])
        for j in range(2, self.n, 2):
            acc[j] = self.madc_lo_cc(x[off + j], b, acc[j])
            acc[j + 1] = self.madc_hi_cc(x[off + j], b, acc[j + 1])

    def row_mad_shift(self, acc, x, b, top, off=0):
        n = self.n
        for j in range(0, n - 2, 2):
            acc[j] = self.madc_lo_cc(x[off + j], b, acc[j + 2])
            acc[j + 1] = self.madc_hi_cc(x[off + j], b, acc[j + 3])
        acc[n - 2] = self.madc_lo_cc(x[off + n - 2], b, top)
        acc[n - 1] = self.madc_hi(x[off + n - 2], b, np.uint64(0))

    # ---- the field operations --------------------------------------------------

    def fe_reduce_once(self, t, hi):
        n = self.n
        d = [None] * n
        d[0] = self.sub_cc(t[0], self.p[0])
        for k in range(1, n):
            d[k] = self.subc_cc(t[k], self.p[k])
        mask = self.subc(hi, np.uint64(0))
        keep = mask != 0
        return [np.where(keep, t[k], d[k]) for k in range(n)]

    def fe_add(self, a, b):
        n = self.n
        s = [self.add_cc(a[0], b[0])] + [None] * (n - 1)
        for k in range(1, n):
            s[k] = self.addc_cc(a[k], b[k])
        zero = np.zeros_like(a[0])
        return self.fe_reduce_once(s, self.addc(zero, zero))

    def fe_sub(self, a, b):
        n = self.n
        d = [self.sub_cc(a[0], b[0])] + [None] * (n - 1)
        for k in range(1, n):
            d[k] = self.subc_cc(a[k], b[k])
        zero = np.zeros_like(a[0])
        mask = self.subc(zero, zero)
        d[0] = self.add_cc(d[0], self.p[0] & mask)
        for k in range(1, n - 1):
            d[k] = self.addc_cc(d[k], self.p[k] & mask)
        d[n - 1] = self.addc(d[n - 1], self.p[n - 1] & mask, wraps=True)
        return d

    def cios_row(self, ev, od, a, b, first):
        n = self.n
        if first:
            self.row_mul(od, a, b, off=1)
            self.row_mul(ev, a, b)
        else:
            ev[0] = self.add_cc(ev[0], od[1])
            self.row_mad_shift(od, a, b, np.uint64(0), off=1)
            self.row_mad(ev, a, b)
            od[n - 1] = self.addc(od[n - 1], np.uint64(0))
        m = (ev[0] * self.nprime) & np.uint64(MASK32)
        self.row_mad(od, self.p, m, off=1)
        self.row_mad(ev, self.p, m)
        od[n - 1] = self.addc(od[n - 1], np.uint64(0))

    def fe_mul(self, a, b):
        n = self.n
        ev, od = [None] * n, [None] * n
        self.cios_row(ev, od, a, b[0], True)
        self.cios_row(od, ev, a, b[1], False)
        for i in range(2, n, 2):
            self.cios_row(ev, od, a, b[i], False)
            self.cios_row(od, ev, a, b[i + 1], False)
        ev[0] = self.add_cc(ev[0], od[1])
        for k in range(1, n - 1):
            ev[k] = self.addc_cc(ev[k], od[k + 1])
        ev[n - 1] = self.addc(ev[n - 1], np.uint64(0))
        return self.fe_reduce_once(ev, np.uint64(0))

    def redc_round(self, ev, od, top):
        n = self.n
        ev[0] = self.add_cc(ev[0], od[1])
        m = (ev[0] * self.nprime) & np.uint64(MASK32)
        self.row_mad_shift(od, self.p, m, top, off=1)
        self.row_mad(ev, self.p, m)
        od[n - 1] = self.addc(od[n - 1], np.uint64(0))

    def fe_redc(self, t):
        n = self.n
        ev, od = list(t[:n]), [None] * n
        m = (ev[0] * self.nprime) & np.uint64(MASK32)
        self.row_mul(od, self.p, m, off=1)
        self.row_mad(ev, self.p, m)
        od[n - 1] = self.addc(od[n - 1], np.uint64(0))
        for r in range(1, n, 2):
            self.redc_round(od, ev, t[n + r - 1])
            if r + 1 < n:
                self.redc_round(ev, od, t[n + r])
        ev[0] = self.add_cc(ev[0], od[1])
        for k in range(1, n - 1):
            ev[k] = self.addc_cc(ev[k], od[k + 1])
        ev[n - 1] = self.addc(ev[n - 1], t[2 * n - 1])
        return self.fe_reduce_once(ev, np.uint64(0))

    def sqr_row(self, acc, a, i, j):
        n = self.n
        s = i + j
        if i == 0:
            for j in range(j, n, 2):
                acc[s] = self._lo(a[i], a[j])
                acc[s + 1] = self._hi(a[i], a[j])
                s += 2
            return
        acc[s] = self.mad_lo_cc(a[i], a[j], acc[s])
        acc[s + 1] = self.madc_hi_cc(a[i], a[j], acc[s + 1])
        j, s = j + 2, s + 2
        while j < n:
            acc[s] = self.madc_lo_cc(a[i], a[j], acc[s])
            acc[s + 1] = self.madc_hi_cc(a[i], a[j], acc[s + 1])
            j, s = j + 2, s + 2
        acc[s] = self.addc(acc[s], np.uint64(0))

    def fe_sqr(self, a):
        n = self.n
        zero = np.zeros_like(a[0])
        e, o = [zero] * (2 * n), [zero] * (2 * n)
        for i in range(n - 1):
            self.sqr_row(o, a, i, i + 1)
            if i + 2 < n:
                self.sqr_row(e, a, i, i + 2)
        t = [None] * (2 * n)
        t[0] = zero
        t[1] = o[1]
        t[2] = self.add_cc(e[2], o[2])
        for k in range(3, 2 * n - 1):
            t[k] = self.addc_cc(e[k], o[k])
        t[2 * n - 1] = self.addc(e[2 * n - 1], o[2 * n - 1])
        assert not (t[2 * n - 1] >> np.uint64(31)).any(), "2S left the top word"
        for k in range(2 * n - 1, 1, -1):
            t[k] = self.funnelshift_l(t[k - 1], t[k])
        t[1] = (t[1] << np.uint64(1)) & np.uint64(MASK32)
        t[0] = self.mad_lo_cc(a[0], a[0], t[0])
        t[1] = self.madc_hi_cc(a[0], a[0], t[1])
        for i in range(1, n - 1):
            t[2 * i] = self.madc_lo_cc(a[i], a[i], t[2 * i])
            t[2 * i + 1] = self.madc_hi_cc(a[i], a[i], t[2 * i + 1])
        t[2 * n - 2] = self.madc_lo_cc(a[n - 1], a[n - 1], t[2 * n - 2])
        t[2 * n - 1] = self.madc_hi(a[n - 1], a[n - 1], t[2 * n - 1])
        return self.fe_redc(t)

    # ---- conversions ------------------------------------------------------------

    def words(self, values, count=None):
        """Python ints -> a list of `count` (default N) uint64 word arrays."""
        count = count or self.n
        return [np.array([(v >> (32 * k)) & MASK32 for v in values], dtype=np.uint64)
                for k in range(count)]

    @staticmethod
    def ints(words):
        """A list of word arrays -> Python ints, lane by lane."""
        out = [0] * len(words[0])
        for k, w in enumerate(words):
            for lane, x in enumerate(w.tolist()):
                out[lane] |= int(x) << (32 * k)
        return out
