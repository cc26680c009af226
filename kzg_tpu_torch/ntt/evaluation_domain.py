"""EvaluationDomain: the user-facing value container of the reference's
`ft.rs:17-288` plus its serde wrapper (port of
`kzg_tpu/ntt/evaluation_domain.py`).

`Domain` (domain.py) owns the cached twiddles and the transforms, built
once per size; `EvaluationDomain` is an IMMUTABLE value holder: every
operation returns a new container wrapping a new tensor. The reference's
`*_assign` method names are kept for API parity but return the result
instead of mutating.

Values are (8, d) Montgomery-form Fr words on one device, the port's native
format; `from_ints` / `to_ints` convert at the host boundary only. `save`
writes the JAX package's `.npz` layout (16-bit limbs in uint32), so either
package loads the other's file.
"""

import numpy as np
import torch

from ..config import resolve_device
from ..constants import R
from ..fields import FR
from ..fields.limb import pack16, unpack16
from .domain import Domain, compute_omega

# distribute_powers table cache: (g mod R, d, device) -> table or (hi, lo)
_POWER_TABLE_CACHE = {}
# at and above this exp, hold power tables as hi/lo sqrt factors (matches
# domain.py's split-table threshold for twiddles)
_SPLIT_POWERS_EXP = 17


def _powers_device(g_int: int, count: int, device):
    """[1, g, g^2, ..., g^(count-1)] as an (8, count) Montgomery tensor,
    built with log2(count) doubling steps on the device (the reference's
    distribute_powers walks a serial host chain, ft.rs:142-156; the
    log-doubling form is O(log d) launches of vectorised multiplies)."""
    p = torch.from_numpy(FR.encode([1])).to(device)
    k = 1
    g_pow = g_int % R
    while k < count:
        # append p * g^k: doubles the table length each step
        p = torch.cat([p, FR.mul_const(p, FR.encode([g_pow])[:, 0])], dim=-1)
        g_pow = (g_pow * g_pow) % R
        k *= 2
    return p[..., :count]


class EvaluationDomain:
    """d = 2^exp evaluations (or coefficients) of a polynomial over the
    omega-domain, mirroring `EvaluationDomain` ft.rs:17-25. Immutable."""

    __slots__ = ("values", "domain")

    def __init__(self, values, domain: Domain):
        self.values = values
        self.domain = domain

    # ---- constructors (ft.rs:82-109) -----------------------------------

    @classmethod
    def from_coeffs(cls, values) -> "EvaluationDomain":
        """Zero-pad an (8, n) Montgomery tensor to the next power of two and
        attach the matching domain (ft.rs:94-109; raises
        PolynomialDegreeTooLarge past Fr's two-adicity via compute_omega)."""
        n = values.shape[-1]
        _, d, exp = compute_omega(n)
        if d != n:
            values = torch.nn.functional.pad(values, (0, d - n))
        return cls(values, Domain(exp))

    @classmethod
    def from_ints(cls, ints, device=None) -> "EvaluationDomain":
        words = torch.from_numpy(FR.encode([x % R for x in ints]))
        return cls.from_coeffs(words.to(resolve_device(device)))

    @classmethod
    def from_polynomial(cls, poly) -> "EvaluationDomain":
        # trimmed(): the domain size must come from the TRACKED degree, not
        # the backing-array slack
        return cls.from_coeffs(poly.trimmed())

    def clone_with_different_coeffs(self, values) -> "EvaluationDomain":
        """ft.rs:78-80: same domain, new values (must be length d)."""
        assert values.shape[-1] == self.d, "values must match the domain size"
        return EvaluationDomain(values, self.domain)

    # ---- accessors ------------------------------------------------------

    @property
    def d(self) -> int:
        return self.domain.d

    @property
    def exp(self) -> int:
        return self.domain.exp

    @property
    def omega(self) -> int:
        return self.domain.omega

    def __len__(self) -> int:
        return self.d

    def into_coeffs(self):
        """The raw (8, d) Montgomery tensor (ft.rs:46-48)."""
        return self.values

    def to_ints(self):
        return FR.decode(self.values)

    def interpolate(self):
        """ifft and wrap as a Polynomial."""
        from ..poly import Polynomial

        return Polynomial(self.domain.intt(self.values))

    # ---- transforms (ft.rs:111-178) -------------------------------------

    def fft(self) -> "EvaluationDomain":
        return EvaluationDomain(self.domain.ntt(self.values), self.domain)

    def ifft(self) -> "EvaluationDomain":
        return EvaluationDomain(self.domain.intt(self.values), self.domain)

    def coset_fft(self) -> "EvaluationDomain":
        return EvaluationDomain(self.domain.coset_ntt(self.values), self.domain)

    def icoset_fft(self) -> "EvaluationDomain":
        return EvaluationDomain(self.domain.coset_intt(self.values), self.domain)

    def distribute_powers(self, g: int) -> "EvaluationDomain":
        """values[i] *= g^i (ft.rs:142-156), with the power table built by
        log-doubling on the device. Tables are cached per (g, d, device);
        for big domains (>= 2^17, matching domain.py's split-table
        threshold) the table is held as O(sqrt d) hi/lo factors,
        g^i = HI[i >> s] * LO[i & (2^s - 1)], applied as two broadcast
        multiplies, never materialising the O(d) table."""
        dev = self.values.device
        key = (g % R, self.d, dev)
        cached = _POWER_TABLE_CACHE.get(key)
        if self.exp >= _SPLIT_POWERS_EXP:
            s = self.exp // 2
            n_lo, n_hi = 1 << s, self.d >> s
            if cached is None:
                lo = _powers_device(g, n_lo, dev)
                hi = _powers_device(pow(g % R, n_lo, R), n_hi, dev)
                cached = _POWER_TABLE_CACHE[key] = (hi, lo)
            hi, lo = cached
            v = self.values.reshape(FR.W, n_hi, n_lo)
            v = FR.mul(FR.mul(v, lo[:, None, :]), hi[:, :, None])
            return EvaluationDomain(v.reshape(FR.W, self.d), self.domain)
        if cached is None:
            cached = _POWER_TABLE_CACHE[key] = _powers_device(g, self.d, dev)
        return EvaluationDomain(FR.mul(self.values, cached), self.domain)

    # ---- vanishing polynomial (ft.rs:182-217) ----------------------------

    def z(self, tau: int) -> int:
        return self.domain.z_at(tau)

    def divide_by_z_on_coset(self) -> "EvaluationDomain":
        return EvaluationDomain(
            self.domain.divide_by_z_on_coset(self.values), self.domain
        )

    # ---- pointwise arithmetic (ft.rs:220-271) ----------------------------
    # names kept for reference parity; these RETURN the result (immutable)

    def mul_assign(self, other: "EvaluationDomain") -> "EvaluationDomain":
        assert self.d == other.d, "domains must match"
        return EvaluationDomain(FR.mul(self.values, other.values), self.domain)

    def sub_assign(self, other: "EvaluationDomain") -> "EvaluationDomain":
        assert self.d == other.d, "domains must match"
        return EvaluationDomain(FR.sub(self.values, other.values), self.domain)

    def add_assign(self, other: "EvaluationDomain") -> "EvaluationDomain":
        assert self.d == other.d, "domains must match"
        return EvaluationDomain(FR.add(self.values, other.values), self.domain)

    def __eq__(self, other):
        if not isinstance(other, EvaluationDomain):
            return NotImplemented
        return self.d == other.d and bool(FR.eq(self.values, other.values).all())

    # value-equality over mutable tensors: explicitly unhashable
    __hash__ = None

    def __repr__(self) -> str:
        return f"EvaluationDomain(d={self.d}, omega=...{self.omega % 10**8})"

    # ---- serialization (SerializableEvaluationDomain, ft.rs:389-434) -----
    # The constants are recomputed from exp on load (they are functions of it).

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            values=unpack16(self.values.cpu()).numpy().astype(np.uint32),
            exp=np.int64(self.exp),
        )

    @classmethod
    def load(cls, path: str, device=None) -> "EvaluationDomain":
        with np.load(path) as blob:
            limbs = blob["values"].astype(np.int64)
            exp = int(blob["exp"])
        values = pack16(torch.from_numpy(limbs)).to(resolve_device(device))
        return cls(values, Domain(exp))
