"""Radix-2 NTT over Fr and the evaluation-domain bookkeeping (port of
`kzg_tpu/ntt/domain.py`).

The same algorithm as the JAX package, so outputs (canonical Montgomery
words) are equal:

  * decimation-in-frequency stages over an (8, *batch, n) word array: the
    Pease constant-geometry loop (every stage pairs the two halves and
    interleaves the results) below 2^ntt_four_step_min_exp points;
  * the four-step (Bailey) decomposition at and above it: C-point NTTs
    along the major axis moving whole R-element rows (`_ntt_axis2`), a
    twiddle multiply, a transpose, R-point NTTs;
  * one bit-reversal gather at the end (`torch.index_select`);
  * the inverse is the forward loop over the inverse table plus a 1/n
    Montgomery scale; coset transforms multiply by powers of g = 7.

Every butterfly stage is kernel K5 (`fields.cuda_field.ntt_stage`): one
launch per stage that reads its twiddles from the domain's half table and
writes the interleaved layout the next stage reads, where the JAX package
built a broadcast twiddle tensor per stage and interleaved with a stack /
reshape. The other field math runs on K1.

Tables are built from host ints as in the JAX package (`Domain._powers`),
kept as numpy words, and copied to each device on first use. Above
2^_BIG_TABLE_EXP no O(n) table is built: the coset powers and the four-step
twiddles use split tables, v[i] = HI[i >> s] * LO[i & (2^s - 1)].

Not ported: the MXU matmul-DFT path (`ntt/mxu.py`, `ntt_mxu` is off by
default in the JAX package), so `_fs_split` is the balanced split and
`_four_step_axis2` is reached only by a direct call.

Omega derivation matches the reference: omega = ROOT_OF_UNITY^(2^(S - exp))
with S = 32, and exp >= S is a PolynomialDegreeTooLarge error.
"""

import numpy as np
import torch

from ..constants import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from ..fields import FR
from ..fields import cuda_field
from ..kzg.errors import PolynomialDegreeTooLarge

# Above this exponent no O(n)-sized table is built (the JAX package's
# reason was XLA graph literals; here it keeps the two packages on the same
# code path, and the split tables cost one extra multiply). 17 so that the
# four-step subdomains of every legal exp (<= 31 -> sub-exp <= 16) keep
# their dense stage tables.
_BIG_TABLE_EXP = 17


def _bitrev_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def compute_omega(num_coeffs: int):
    """(omega, d, exp) for the smallest power-of-two domain >= num_coeffs
    (reference ft.rs:55-76)."""
    exp = max(1, (num_coeffs - 1).bit_length()) if num_coeffs > 1 else 0
    if exp >= FR_TWO_ADICITY:
        raise PolynomialDegreeTooLarge(
            f"domain 2^{exp} exceeds Fr two-adicity 2^{FR_TWO_ADICITY}"
        )
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - exp), R)
    return omega, 1 << exp, exp


class Domain:
    """A 2^exp evaluation domain over Fr with cached twiddles. Input and
    output: (8, *batch, d) Montgomery Fr words on any one device.

    One instance per exp (`Domain(exp)` returns the cached one).
    `as_plain()` gives a twin of the domain whose stages and field math are
    the plain PyTorch versions on every device (the reference that
    `chip_smoke.py` holds the kernels against on the card)."""

    _cache = {}

    def __new__(cls, exp: int):
        if exp in cls._cache:
            return cls._cache[exp]
        self = super().__new__(cls)
        cls._cache[exp] = self
        return self

    def __init__(self, exp: int):
        if getattr(self, "_ready", False):
            return
        if exp >= FR_TWO_ADICITY:
            raise PolynomialDegreeTooLarge(
                f"domain 2^{exp} exceeds Fr two-adicity 2^{FR_TWO_ADICITY}"
            )
        self.exp = exp
        self.d = 1 << exp
        self.omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - exp), R)
        self.omega_inv = pow(self.omega, -1, R)
        self.d_inv = pow(self.d, -1, R)
        self.gen = FR_GENERATOR
        self.gen_inv = pow(FR_GENERATOR, -1, R)
        self.F = FR
        self.stage = cuda_field.ntt_stage
        self.plain = False
        self._twin = None
        self._dev = {}  # (table name, device) -> tensor
        self._fs = {}  # inverse -> four-step constants
        self._tables = {"dinv": FR.encode([self.d_inv])[:, 0]}
        half = max(1, self.d // 2)
        if exp < _BIG_TABLE_EXP:
            self._tables.update(
                bitrev=_bitrev_perm(exp),
                tw_fwd=self._powers(self.omega, half),
                tw_inv=self._powers(self.omega_inv, half),
                coset_fwd=self._powers(self.gen, self.d),
                coset_inv=self._powers(self.gen_inv, self.d),
            )
            self.split = None
        else:
            # big domain: no O(n) table (see _BIG_TABLE_EXP). The Pease loop
            # is unreachable (the four-step gate is forced on) and coset
            # multiplies use split tables.
            sc = exp // 2
            step = 1 << sc
            self.split = sc
            self._tables.update(
                coset_fwd_hi=self._powers_step(self.gen, step, self.d >> sc),
                coset_fwd_lo=self._powers(self.gen, step),
                coset_inv_hi=self._powers_step(self.gen_inv, step, self.d >> sc),
                coset_inv_lo=self._powers(self.gen_inv, step),
            )
        self._ready = True

    def as_plain(self) -> "Domain":
        """This domain with the plain PyTorch K5 stage and plain field ops,
        whatever the device (shares the tables)."""
        if self.plain:
            return self
        if self._twin is None:
            twin = object.__new__(Domain)  # not cached: Domain(exp) stays the kernel one
            twin.__dict__.update(self.__dict__)
            twin.F = FR.as_plain()
            twin.stage = cuda_field.ntt_stage_layout_plain
            twin.plain = True
            twin._twin = twin
            self._twin = twin
        return self._twin

    def _sub(self, exp: int) -> "Domain":
        dom = Domain(exp)
        return dom.as_plain() if self.plain else dom

    @staticmethod
    def _powers(base: int, count: int) -> np.ndarray:
        """(8, count) Montgomery words of base^0 .. base^(count-1), from
        host integers."""
        ints = []
        cur = 1
        for _ in range(count):
            ints.append(cur)
            cur = cur * base % R
        return FR.encode(ints)

    @staticmethod
    def _powers_step(base: int, step: int, count: int) -> np.ndarray:
        """(8, count) Montgomery words of base^(step*i), i < count."""
        return Domain._powers(pow(base, step, R), count)

    def _table(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.from_numpy(self._tables[name]).to(device)
            self._dev[key] = t
        return t

    # ---- four-step (Bailey) decomposition ----------------------------------

    def _fs_split(self):
        """(exp_r, exp_c), balanced (the MXU-pinned split is not ported)."""
        exp_r = self.exp // 2
        return exp_r, self.exp - exp_r

    def _four_step_consts(self, inverse: bool):
        """(expR, expC, s, WH, WL): the twiddle matrix W[k2, j1] =
        omega^(+-j1*k2) in split form W[k2, j1] = WH[k2, j1 >> s] *
        WL[k2, j1 & (2^s - 1)], WH (8, C, R >> s), WL (8, C, 2^s) numpy
        words. Built lazily per direction."""
        if inverse not in self._fs:
            exp_r, exp_c = self._fs_split()
            rn, cn = 1 << exp_r, 1 << exp_c
            s = exp_r // 2
            base = self.omega_inv if inverse else self.omega
            hi_ints, lo_ints = [], []
            for k2 in range(cn):
                q = pow(base, k2, R)
                qs = pow(q, 1 << s, R)
                cur = 1
                for _ in range(rn >> s):  # WH row: powers of base^(k2 << s)
                    hi_ints.append(cur)
                    cur = cur * qs % R
                cur = 1
                for _ in range(1 << s):  # WL row: powers of base^k2
                    lo_ints.append(cur)
                    cur = cur * q % R
            wh = FR.encode(hi_ints).reshape(FR.W, cn, rn >> s)
            wl = FR.encode(lo_ints).reshape(FR.W, cn, 1 << s)
            tag = "inv" if inverse else "fwd"
            self._tables[f"fs_{tag}_hi"] = wh
            self._tables[f"fs_{tag}_lo"] = wl
            self._fs[inverse] = (exp_r, exp_c, s, f"fs_{tag}_hi", f"fs_{tag}_lo")
        return self._fs[inverse]

    def _ntt_four_step(self, x, inverse: bool):
        """n = R*C NTT as C-point NTTs + twiddle + transpose + R-point NTTs.
        With j = j1 + R*j2 and k = k2 + C*k1:

            Y[k2, j1] = NTT_C over j2 of x[j1 + R*j2]     (axis -2)
            Z[k2, j1] = Y[k2, j1] * omega^(j1*k2)
            X[k2 + C*k1] = NTT_R over j1 of Z[., k2]      (axis -2 after
                                                           one transpose)
        """
        exp_r, exp_c, s, wh_name, wl_name = self._four_step_consts(inverse)
        rn, cn = 1 << exp_r, 1 << exp_c
        nl = x.dim() - 2
        wh = self._table(wh_name, x.device)
        wl = self._table(wl_name, x.device)
        x = x.reshape(x.shape[:-1] + (cn, rn))  # [j2, j1]
        x = self._sub(exp_c)._ntt_axis2(x, inverse)  # -> [k2, j1]
        xs = x.reshape(x.shape[:-1] + (rn >> s, 1 << s))
        xs = self.F.mul(xs, wh.reshape((FR.W,) + (1,) * nl + (cn, rn >> s, 1)))
        xs = self.F.mul(xs, wl.reshape((FR.W,) + (1,) * nl + (cn, 1, 1 << s)))
        x = xs.reshape(x.shape).transpose(-1, -2)  # [j1, k2]
        x = self._sub(exp_r)._ntt_axis2(x, inverse)  # -> [k1, k2]
        return x.reshape(x.shape[:-2] + (self.d,))

    def _four_step_axis2(self, x, inverse: bool):
        """Four-step recursion ALONG AXIS -2 of (8, *lead, m, bt), bt riding
        along as a trailing batch axis of each sub-NTT (the JAX package's
        MXU path reduces blocks to matmul-DFT leaves with it)."""
        exp_r, exp_c, s, wh_name, wl_name = self._four_step_consts(inverse)
        rn, cn = 1 << exp_r, 1 << exp_c
        bt = x.shape[-1]
        lead = tuple(x.shape[1:-2])
        nl = len(lead)
        wh = self._table(wh_name, x.device)
        wl = self._table(wl_name, x.device)
        x = x.reshape(x.shape[:-2] + (cn, rn * bt))  # [j2, (j1, bt)]
        x = self._sub(exp_c)._ntt_axis2(x, inverse)  # -> [k2, (j1, bt)]
        x = x.reshape(x.shape[:-1] + (rn >> s, (1 << s) * bt))
        x = self.F.mul(x, wh.reshape((FR.W,) + (1,) * nl + (cn, rn >> s, 1)))
        x = x.reshape(x.shape[:-1] + (1 << s, bt))
        x = self.F.mul(x, wl.reshape((FR.W,) + (1,) * nl + (cn, 1, 1 << s, 1)))
        x = x.reshape(x.shape[:-3] + (rn, bt))  # [k2, j1, bt]
        x = x.transpose(-3, -2)  # [j1, k2, bt]
        x = x.reshape(x.shape[:-2] + (cn * bt,))
        x = self._sub(exp_r)._ntt_axis2(x, inverse)  # -> [k1, (k2, bt)]
        return x.reshape((FR.W,) + lead + (self.d, bt))

    def _stages(self, x, inverse: bool):
        """The DIF stage loop over x (8, nb, m, bt) along axis 2 (one K5
        launch per stage), in bit-reversed output order."""
        tw = self._table("tw_inv" if inverse else "tw_fwd", x.device)
        for s in range(self.exp):
            x = self.stage(x, tw, s)
        return x

    def _ntt_axis2(self, x, inverse: bool):
        """The stage loop transforming axis -2 of (8, *lead, m, bt): every
        butterfly, interleave and the bit reversal move whole bt-element
        rows."""
        if self.d == 1:
            return x
        shape = x.shape
        bt = shape[-1]
        y = self._stages(x.reshape(FR.W, -1, self.d, bt), inverse).reshape(shape)
        y = torch.index_select(y, -2, self._table("bitrev", x.device))
        if inverse:
            y = self.F.mul_const(y, self._tables["dinv"])
        return y

    # ---- core transform -----------------------------------------------------

    def _ntt(self, x, inverse: bool):
        """Pease constant-geometry DIF below the four-step gate: every stage
        splits the array into halves, butterflies with twiddle
        omega^(j & ~(2^s - 1)) at stage s, and interleaves."""
        if self.d == 1:
            return x
        from ..config import get_config

        # config can lower the four-step gate (tests force it small) but
        # not raise it past _BIG_TABLE_EXP: big domains have no dense
        # stage tables, so the Pease loop is not an option there
        gate = max(4, min(get_config().ntt_four_step_min_exp, _BIG_TABLE_EXP))
        if self.exp >= gate:
            return self._ntt_four_step(x, inverse)
        shape = x.shape
        y = self._stages(x.reshape(FR.W, -1, self.d, 1), inverse).reshape(shape)
        y = torch.index_select(y, -1, self._table("bitrev", x.device))
        if inverse:
            y = self.F.mul_const(y, self._tables["dinv"])
        return y

    def _mul_coset(self, x, inverse: bool):
        """x times g^i (g^-i for the inverse) along the last axis, from the
        dense table or, above _BIG_TABLE_EXP, from the split tables."""
        tag = "inv" if inverse else "fwd"
        nb = x.dim() - 2
        if self.split is None:
            t = self._table(f"coset_{tag}", x.device)
            return self.F.mul(x, t.reshape((FR.W,) + (1,) * nb + (self.d,)))
        sc = self.split
        hi = self._table(f"coset_{tag}_hi", x.device)
        lo = self._table(f"coset_{tag}_lo", x.device)
        xs = x.reshape(x.shape[:-1] + (self.d >> sc, 1 << sc))
        xs = self.F.mul(xs, hi.reshape((FR.W,) + (1,) * nb + (self.d >> sc, 1)))
        xs = self.F.mul(xs, lo.reshape((FR.W,) + (1,) * nb + (1, 1 << sc)))
        return xs.reshape(x.shape)

    # ---- public API (reference ft.rs:111-178 parity) -------------------------

    def ntt(self, coeffs):
        """Coefficients -> evaluations over the omega-domain."""
        return self._ntt(coeffs, inverse=False)

    def intt(self, evals):
        """Evaluations -> coefficients (scaled by 1/d)."""
        return self._ntt(evals, inverse=True)

    def coset_ntt(self, coeffs):
        """Evaluate over the coset g*<omega> (ft.rs:158-166 semantics)."""
        return self._ntt(self._mul_coset(coeffs, inverse=False), inverse=False)

    def coset_intt(self, evals):
        """Inverse of coset_ntt (ft.rs:168-178 semantics)."""
        return self._mul_coset(self._ntt(evals, inverse=True), inverse=True)

    # ---- vanishing polynomial helpers (ft.rs:182-217 parity) -----------------

    def z_at(self, tau_int: int) -> int:
        """Evaluate Z(tau) = tau^d - 1 (host-side scalar)."""
        return (pow(tau_int, self.d, R) - 1) % R

    def divide_by_z_on_coset(self, coset_evals):
        """Divide coset evaluations by Z(g*omega^i) = g^d - 1 (constant on
        the coset), matching ft.rs:194-217."""
        zinv = pow(pow(self.gen, self.d, R) - 1, -1, R)
        return self.F.mul_const(coset_evals, FR.encode([zinv])[:, 0])
