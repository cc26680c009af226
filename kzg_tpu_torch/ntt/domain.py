"""Radix-2 NTT over Fr and the evaluation-domain bookkeeping (port of
`kzg_tpu/ntt/domain.py`).

Outputs are canonical Montgomery words, the same as the JAX package's,
whatever decomposition of the DFT computes them. Two routes:

The card's route (a `Domain` on CUDA tensors, and on CPU tensors through
the kernel's plain twin): kernel K5 as a block transform,
`fields.cuda_field.ntt_block`, which runs every DIF stage of a
sub-transform of up to 2^BLOCK_MAX_EXP points in shared memory in one
launch, writes natural order (the bit reversal stays on chip) and
multiplies its input and output by per-element scales:

  * 2^e <= 2^BLOCK_MAX_EXP points: one launch, the coset powers fused
    into its loads, the 1/d scale (and the inverse coset powers) into its
    stores;
  * up to 2^(2 BLOCK_MAX_EXP): the four-step (Bailey) decomposition, d =
    R C, in two launches: C-point transforms along the major axis with the
    coset powers fused before and the twiddle W[k2, j1] = omega^(j1 k2)
    after, then R-point transforms that read each row of the first pass's
    output as a contiguous transform and store it transposed, with the 1/d
    and inverse coset scales fused (`_block_axis2`);
  * above that (no path gets there), the same four-step recursion along
    axis 2, a sub-pass that is itself four-stepped taking the twiddle as a
    K1 product and the transpose as a copy.

This differs from the reference's routing, which runs the Pease loop below
2^ntt_four_step_min_exp (16) points and the four-step at and above it: the
card's route four-steps only above 2^BLOCK_MAX_EXP, whatever that setting.

The reference's route (`as_plain()`, the twin that `chip_smoke.py` holds
the card against, and every domain under `config.ntt_mxu`):

  * decimation-in-frequency stages over an (8, *batch, n) word array: the
    Pease constant-geometry loop (every stage pairs the two halves and
    interleaves the results) below 2^ntt_four_step_min_exp points;
  * the four-step (Bailey) decomposition at and above it: C-point NTTs
    along the major axis moving whole R-element rows (`_ntt_axis2`), a
    twiddle multiply, a transpose, R-point NTTs;
  * one bit-reversal gather at the end (`torch.index_select`);
  * the inverse is the forward loop over the inverse table plus a 1/n
    Montgomery scale; coset transforms multiply by powers of g = 7.
Every butterfly stage there is one K5 stage (`fields.cuda_field.ntt_stage`,
on the plain twin `ntt_stage_layout_plain` in `as_plain()`): one launch per
stage that reads its twiddles from the domain's half table and writes the
interleaved layout the next stage reads.

Tables are built from host ints as in the JAX package (`Domain._powers`),
kept as numpy words, and copied to each device on first use. Above
2^_BIG_TABLE_EXP no O(n) table is built: the coset powers and the four-step
twiddles use split tables, v[i] = HI[i >> s] * LO[i & (2^s - 1)].
`ntt_block` reads its tables element-major, (len, 8) words.

With `config.ntt_mxu` on for the tensor's device (`ntt/mxu.py`; off by
default, as in the JAX package) every domain above 2^7 points four-steps
down to matmul-DFT leaves: `_fs_split` pins the first factor to 2^7 above
2^14 points (2^20 -> (7, 13) -> (7, 6): three matmul passes), `_ntt_axis2`
sends blocks of up to 2^7 points to `mxu.dft_axis2` (the product and kernel
K9) and larger ones to `_four_step_axis2`, and no K5 entry launches there.

Omega derivation matches the reference: omega = ROOT_OF_UNITY^(2^(S - exp))
with S = 32, and exp >= S is a PolynomialDegreeTooLarge error.
"""

import numpy as np
import torch

from ..constants import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R
from ..fields import FR
from ..fields import cuda_field
from ..kzg.errors import PolynomialDegreeTooLarge
from . import mxu

# Above this exponent no O(n)-sized table is built (the JAX package's
# reason was XLA graph literals; here it keeps the two packages on the same
# code path, and the split tables cost one extra multiply). 17 so that the
# four-step subdomains of every legal exp (<= 31 -> sub-exp <= 16) keep
# their dense stage tables.
_BIG_TABLE_EXP = 17

# The largest transform `ntt_block` runs in one launch (a tile of 2^12 Fr
# elements is 128 KB of shared memory; csrc/ntt_block.cuh), T: the card's
# route four-steps above 2^T points. Tests lower it to reach the four-step
# composition and its recursion at small sizes.
BLOCK_MAX_EXP = 12
# Dense per-element scale tables up to 2^this entries, split tables above.
_DENSE_SCALE_EXP = 12


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

    One instance per exp (`Domain(exp)` returns the cached one); it takes
    the `ntt_block` route. `as_plain()` gives a twin of the domain that
    takes the reference's route of stages, with the plain PyTorch versions
    of the stage and the field math on every device (the reference that
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
        self.block = True  # the ntt_block route (False: the reference's stage loop)
        self._twin = None
        self._stages_twin = None
        self._dev = {}  # (table name, device) -> tensor
        self._fs = {}  # (inverse, exp_r) -> four-step constants
        self._tables = {"dinv": FR.encode([self.d_inv])[:, 0]}
        half = max(1, self.d // 2)
        if exp < _BIG_TABLE_EXP:
            self._tables.update(
                bitrev=cuda_field.bitrev_perm(exp),
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
        """This domain on the reference's route with the plain PyTorch K5
        stage and plain field ops, whatever the device (shares the
        tables)."""
        if self.plain:
            return self
        if self._twin is None:
            self._twin = self._variant(FR.as_plain(), cuda_field.ntt_stage_layout_plain, True)
        return self._twin

    def as_stages(self) -> "Domain":
        """This domain on the reference's route as the card ran it before
        `ntt_block`: one K5 stage launch a stage (`cuda_field.ntt_stage`),
        the bit reversal a gather, the scales K1 products (kept to time the
        block route against)."""
        if not self.block:
            return self
        if self._stages_twin is None:
            self._stages_twin = self._variant(FR, cuda_field.ntt_stage, False)
        return self._stages_twin

    def _variant(self, field, stage, plain: bool) -> "Domain":
        twin = object.__new__(Domain)  # not cached: Domain(exp) stays the block one
        twin.__dict__.update(self.__dict__)
        twin.F, twin.stage, twin.plain, twin.block = field, stage, plain, False
        twin._twin = twin if plain else None
        twin._stages_twin = twin
        return twin

    def _sub(self, exp: int) -> "Domain":
        dom = Domain(exp)
        if self.block:
            return dom
        return dom.as_plain() if self.plain else dom.as_stages()

    @staticmethod
    def _powers(base: int, count: int, const: int = 1) -> np.ndarray:
        """(8, count) Montgomery words of const * base^0 .. base^(count-1),
        from host integers."""
        ints = []
        cur = const % R
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

    # ---- the card's route: ntt_block --------------------------------------------

    def _stage_table(self, inverse: bool, device) -> torch.Tensor:
        """(d, 8) element-major stage table of `ntt_block`: entry h + j is
        omega^(+-j d / 2h), the twiddle of butterfly j at half-size h."""
        name = f"stage_{'inv' if inverse else 'fwd'}"
        if name not in self._tables:
            half = self._tables.get("tw_inv" if inverse else "tw_fwd")
            if half is None:  # a big domain (no dense tables) taken as one block
                half = self._powers(self.omega_inv if inverse else self.omega, self.d // 2)
            idx = [0]
            h = 1
            while h < self.d:
                idx += [j * (self.d // (2 * h)) for j in range(h)]
                h *= 2
            self._tables[name] = np.ascontiguousarray(half[:, idx].T)
        return self._table(name, device)

    def _scale(self, name: str, device, kind: str, base: int, const: int = 1,
               div: int = 1) -> cuda_field.NttScale:
        """An `ntt_block` scale of const * base^e, e < d (kind "linear" or
        "product"), from a dense table up to 2^_DENSE_SCALE_EXP entries and
        split tables above; `const` alone for kind "const"."""
        if kind == "const":
            if name not in self._tables:
                self._tables[name] = np.ascontiguousarray(FR.encode([const]).T)
            return cuda_field.NttScale("const", self._table(name, device))
        if self.exp <= _DENSE_SCALE_EXP:
            if name not in self._tables:
                self._tables[name] = np.ascontiguousarray(self._powers(base, self.d, const).T)
            return cuda_field.NttScale(kind, self._table(name, device), div=div)
        sc = self.exp // 2
        if f"{name}_hi" not in self._tables:
            self._tables[f"{name}_hi"] = np.ascontiguousarray(
                self._powers(pow(base, 1 << sc, R), self.d >> sc, const).T)
            self._tables[f"{name}_lo"] = np.ascontiguousarray(self._powers(base, 1 << sc).T)
        return cuda_field.NttScale(kind, self._table(f"{name}_lo", device),
                                   self._table(f"{name}_hi", device), sc, div)

    def _block_split(self):
        """(exp_r, exp_c) of the card's four-step: balanced, the second
        pass's R the larger where d is an odd power (`bench.ntt`'s sweep,
        H100: the fastest split at 2^15 and 2^20)."""
        exp_r = (self.exp + 1) // 2
        return exp_r, self.exp - exp_r

    def _block_axis2(self, x, inverse: bool, pre=None, post=None):
        """The transform along axis 2 of x (8, nb, d, bt) on `ntt_block`,
        without the 1/d scale, x times `pre` before and the result times
        `post` after (linear or const scales, e = row * bt + column).
        One launch up to 2^BLOCK_MAX_EXP points; above it the four-step
        with d = R C, j = j1 + R j2, k = k2 + C k1:

            Y[k2, j1] = NTT_C over j2 of pre * x     (launch 1, columns
                        (j1, c), times W[k2, j1] = omega^(j1 k2) on store)
            X[k2 + C k1] = NTT_R over j1 of Y[k2, .] (launch 2: each row
                        of Y is a contiguous transform; stored transposed,
                        times post)
        A pass above 2^BLOCK_MAX_EXP points recurses: its twiddle is then a
        K1 product and the second pass's transpose a copy."""
        if self.exp <= BLOCK_MAX_EXP:
            return cuda_field.ntt_block(x, self._stage_table(inverse, x.device), pre, post)
        W, nb, _, bt = x.shape
        exp_r, exp_c = self._block_split()
        rn, cn = 1 << exp_r, 1 << exp_c
        sub_c, sub_r = Domain(exp_c), Domain(exp_r)
        tw = self._scale(f"twiddle_{'inv' if inverse else 'fwd'}", x.device, "product",
                         self.omega_inv if inverse else self.omega, div=bt)
        x = x.reshape(W, nb, cn, rn * bt)  # [j2, (j1, c)]
        if exp_c <= BLOCK_MAX_EXP:
            y = sub_c._block_axis2(x, inverse, pre, tw)
        else:
            y = sub_c._block_axis2(x, inverse, pre)
            y = self.F.mul(y, tw.values(cn, rn * bt, self.F.mul).unsqueeze(1))
        if exp_r <= BLOCK_MAX_EXP:  # rows of Y in, [k1, (k2, c)] out
            z = cuda_field.ntt_block(y.reshape(W, nb * cn, rn, bt),
                                     sub_r._stage_table(inverse, x.device), None, post,
                                     out_bt=cn * bt)
        else:
            yt = y.reshape(W, nb, cn, rn, bt).transpose(2, 3).contiguous()
            z = sub_r._block_axis2(yt.reshape(W, nb, rn, cn * bt), inverse, None, post)
        return z.reshape(W, nb, self.d, bt)

    def _block_ntt(self, x, inverse: bool, coset: bool, bt: int = 1):
        """A transform of (8, *lead, d, bt) (bt = 1: (8, *batch, d)) along
        its axis -2 on the `ntt_block` route, the inverse scaled by 1/d,
        coset ones with the powers of g fused."""
        dev = x.device
        pre = post = None
        if coset and not inverse:
            pre = self._scale("coset_fwd_scale", dev, "linear", self.gen)
        if inverse:
            post = (self._scale("coset_inv_scale", dev, "linear", self.gen_inv, self.d_inv)
                    if coset else self._scale("dinv_scale", dev, "const", 0, self.d_inv))
        x4 = x.reshape(FR.W, -1, self.d, bt)
        return self._block_axis2(x4, inverse, pre, post).reshape(x.shape)

    # ---- four-step (Bailey) decomposition ----------------------------------

    def _fs_split(self, device):
        """(exp_r, exp_c) of the four-step factorisation for a tensor on
        `device`. Balanced by default; on the matmul-DFT path the first
        factor is pinned to the block edge 2^7 above 2^14 points, so deep
        sizes recurse in the fewest levels."""
        if mxu.mxu_available(device) and self.exp > 2 * mxu._MAX_EXP:
            exp_r = mxu._MAX_EXP
        else:
            exp_r = self.exp // 2
        return exp_r, self.exp - exp_r

    def _four_step_consts(self, inverse: bool, device):
        """(expR, expC, s, WH, WL): the twiddle matrix W[k2, j1] =
        omega^(+-j1*k2) in split form W[k2, j1] = WH[k2, j1 >> s] *
        WL[k2, j1 & (2^s - 1)], WH (8, C, R >> s), WL (8, C, 2^s) numpy
        words. Built lazily per (direction, split): the split follows
        config.ntt_mxu, which may change between calls."""
        exp_r, exp_c = self._fs_split(device)
        if (inverse, exp_r) not in self._fs:
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
            tag = f"fs_{'inv' if inverse else 'fwd'}_{exp_r}"
            self._tables[f"{tag}_hi"] = wh
            self._tables[f"{tag}_lo"] = wl
            self._fs[inverse, exp_r] = (exp_r, exp_c, s, f"{tag}_hi", f"{tag}_lo")
        return self._fs[inverse, exp_r]

    def _ntt_four_step(self, x, inverse: bool):
        """n = R*C NTT as C-point NTTs + twiddle + transpose + R-point NTTs.
        With j = j1 + R*j2 and k = k2 + C*k1:

            Y[k2, j1] = NTT_C over j2 of x[j1 + R*j2]     (axis -2)
            Z[k2, j1] = Y[k2, j1] * omega^(j1*k2)
            X[k2 + C*k1] = NTT_R over j1 of Z[., k2]      (axis -2 after
                                                           one transpose)
        """
        exp_r, exp_c, s, wh_name, wl_name = self._four_step_consts(inverse, x.device)
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
        matmul-DFT path reduces blocks to leaves of up to 2^7 points with
        it)."""
        exp_r, exp_c, s, wh_name, wl_name = self._four_step_consts(inverse, x.device)
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
        if mxu.mxu_available(x.device):
            if self.exp <= mxu._MAX_EXP:
                return mxu.dft_axis2(self.exp, inverse, x, plain=self.plain)
            return self._four_step_axis2(x, inverse)
        if self.block:
            return self._block_ntt(x, inverse, False, bt=x.shape[-1])
        shape = x.shape
        bt = shape[-1]
        y = self._stages(x.reshape(FR.W, -1, self.d, bt), inverse).reshape(shape)
        y = torch.index_select(y, -2, self._table("bitrev", x.device))
        if inverse:
            y = self.F.mul_const(y, self._tables["dinv"])
        return y

    # ---- core transform -----------------------------------------------------

    def _ntt(self, x, inverse: bool, coset: bool = False):
        """The transform of (8, *batch, d) along its last axis, coset ones
        (coset=True) times g^i before the forward and g^-i after the
        inverse. The `ntt_block` route unless the domain is a stage-loop
        twin (`as_plain`, `as_stages`) or the matmul-DFT path is on; there
        the reference's route: Pease
        constant-geometry DIF below the four-step gate (every stage splits
        the array into halves, butterflies with twiddle
        omega^(j & ~(2^s - 1)) at stage s, and interleaves), four-step at
        and above it."""
        if self.d == 1:
            return x
        if self.block and not mxu.mxu_available(x.device):
            return self._block_ntt(x, inverse, coset)
        if coset and not inverse:
            x = self._mul_coset(x, inverse=False)
        y = self._ntt_stages(x, inverse)
        return self._mul_coset(y, inverse=True) if coset and inverse else y

    def _ntt_stages(self, x, inverse: bool):
        """The reference's route of `_ntt`: Pease or four-step, on K5 stages."""
        from ..config import get_config

        # config can lower the four-step gate (tests force it small) but
        # not raise it past _BIG_TABLE_EXP: big domains have no dense
        # stage tables, so the Pease loop is not an option there. On the
        # matmul-DFT path everything above the block edge four-steps down
        # to matmul leaves.
        gate = max(4, min(get_config().ntt_four_step_min_exp, _BIG_TABLE_EXP))
        if mxu.mxu_available(x.device):
            gate = min(gate, mxu._MAX_EXP + 1)
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
        return self._ntt(coeffs, inverse=False, coset=True)

    def coset_intt(self, evals):
        """Inverse of coset_ntt (ft.rs:168-178 semantics)."""
        return self._ntt(evals, inverse=True, coset=True)

    # ---- vanishing polynomial helpers (ft.rs:182-217 parity) -----------------

    def z_at(self, tau_int: int) -> int:
        """Evaluate Z(tau) = tau^d - 1 (host-side scalar)."""
        return (pow(tau_int, self.d, R) - 1) % R

    def divide_by_z_on_coset(self, coset_evals):
        """Divide coset evaluations by Z(g*omega^i) = g^d - 1 (constant on
        the coset), matching ft.rs:194-217."""
        zinv = pow(pow(self.gen, self.d, R) - 1, -1, R)
        return self.F.mul_const(coset_evals, FR.encode([zinv])[:, 0])
