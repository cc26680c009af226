"""Dense polynomials over Fr (port of `kzg_tpu/poly/polynomial.py`).

Coefficients are an (8, n) int32 tensor of Montgomery Fr words (word axis
leading, coefficient index on the batch axis) with the degree tracked as a
host int. Evaluation and linear division, XLA scans over the K1 kernel in
the JAX package, run on the Horner kernel `fr_horner` (`poly/horner.py`), at any number of
points.
Above 2^(div_chunk_log + 1) coefficients the linear division runs chunk by
chunk, high to low (`_div_by_linear_big`, one `fr_horner` call a chunk,
`_div_stream_chunk`), which is also the step of the streamed witness.
Multiplication is NTT-based at every size (`_mul_ntt`: both operands in
one stacked forward transform and one inverse, each one `ntt_block`
launch up to 2^12 points); long division is a schoolbook loop for short quotients
and Newton-inverse division above `newton_div_threshold` (poly/newton.py).
"""

import torch

from ..config import get_config, resolve_device
from ..fields import FR
from ..ntt import Domain
from ..trace import span
from .horner import fr_horner


def _pad_to(c: torch.Tensor, n: int) -> torch.Tensor:
    if c.shape[-1] == n:
        return c
    return torch.nn.functional.pad(c, (0, n - c.shape[-1]))


def _mul_ntt(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Product of coefficient arrays via NTT (reference fft_mul semantics,
    polynomial.rs:167-183), batched over any leading dims. Operands of one
    shape after padding go through one stacked forward transform."""
    exp = max(1, (out_len - 1).bit_length())
    dom = Domain(exp)
    a, b = _pad_to(a, dom.d), _pad_to(b, dom.d)
    if a.shape == b.shape:
        fa, fb = dom.ntt(torch.stack([a, b], dim=1)).unbind(1)
    else:
        fa, fb = dom.ntt(a), dom.ntt(b)
    return dom.intt(FR.mul(fa, fb))[..., :out_len]


def _mul_naive(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product, one shifted multiply-add per coefficient of the
    shorter operand (the parity oracle for `_mul_ntt`, mirroring the
    reference's naive Mul, polynomial.rs:473-487)."""
    if b.shape[-1] > a.shape[-1]:
        a, b = b, a
    na, nb = a.shape[-1], b.shape[-1]
    apad = _pad_to(a, na + nb - 1)
    acc = FR.zeros(apad.shape[1:], a.device)
    for j in range(nb):
        acc = FR.add(acc, FR.mul(torch.roll(apad, j, dims=-1), b[..., j:j + 1]))
    return acc


def _eval_many(coeffs: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Evaluate one polynomial (8, n) at points (8, k) -> (8, k)
    (`kzg_tpu/poly/polynomial.py:93-118`) by `fr_horner`'s remainder."""
    return fr_horner(coeffs, pts, rem_only=True)[1]


def _div_by_linear(f: torch.Tensor, x: torch.Tensor):
    """Quotient and remainder of f / (X - x), x of shape (8, k)
    (`kzg_tpu/poly/polynomial.py:121-145`), by `fr_horner`.
    Returns (8, k, n-1) quotients and (8, k) remainders f(x)."""
    return fr_horner(f, x)


def _div_stream_chunk(fc: torch.Tensor, x: torch.Tensor, carry: torch.Tensor):
    """One high-to-low chunk step of the linear division f / (X - x)
    (`kzg_tpu/poly/polynomial.py:217-228`): fc (8, m) the chunk's
    coefficients, x (8, 1), carry (8, 1) the Horner value of the
    coefficients above the chunk (0 for the top one). Returns the chunk's
    quotient (8, m) and the new carry (8, 1); the last carry is f(x).

    One `fr_horner` call: the reference's carry C_c is Horner's h_off and
    its q_{off + j} is h_{off + j + 1}, so the chunk quotient is fr_horner's
    q with the carry in on top, and the carry out is its remainder, the
    same canonical words. The reference's per-divisor constants
    (`_div_stream_consts`: powers of x and of 1/x over a chunk) have no
    counterpart: the Horner kernel needs only x."""
    q, rem = fr_horner(fc, x, carry=carry)
    return torch.cat([q[:, 0], carry], dim=-1), rem


def _div_by_linear_big(f: torch.Tensor, x: torch.Tensor, chunk_log: int):
    """Memory-bounded `_div_by_linear` for one divisor x (8, 1)
    (`kzg_tpu/poly/polynomial.py:148-195`): chunks of 2^chunk_log
    coefficients, high to low, each one `_div_stream_chunk` written into one
    preallocated quotient, so the temporaries are one chunk's. Returns
    (q (8, 1, max(n - 1, 1)), rem (8, 1)). At x = 0 every step is the
    coefficient shift (h_j = f_j), as in the reference."""
    n = f.shape[-1]
    m = 1 << chunk_log
    q = torch.empty((FR.W, n), dtype=torch.int32, device=f.device)
    carry = FR.zeros((1,), f.device)
    for off in range((n - 1) // m * m, -1, -m):
        qc, carry = _div_stream_chunk(f[:, off:off + m], x, carry)
        q[:, off:off + qc.shape[-1]] = qc
    return q[:, None, :max(n - 1, 1)], carry


def _long_division(f: torch.Tensor, d: torch.Tensor, nf: int, nd: int):
    """Schoolbook long division (reference polynomial.rs:193-227): returns
    (quotient, remainder). nf / nd are true coefficient counts; d's leading
    coefficient must be nonzero. One step per quotient coefficient, high to
    low."""
    f = f[..., :nf]
    d = d[..., :nd]
    steps = nf - nd + 1
    if steps <= 0:
        return FR.zeros((1,), f.device), f  # quotient 0, remainder f
    dlead_inv = FR.inv(d[..., nd - 1:nd])
    dtop = torch.roll(_pad_to(d, nf), nf - nd, dims=-1)  # d's coeffs at [nf-nd, nf)
    rem = f
    qs = []
    for _ in range(steps):
        factor = FR.mul(rem[..., nf - 1:nf], dlead_inv)
        rem = torch.roll(FR.sub(rem, FR.mul(dtop, factor)), 1, dims=-1)
        qs.append(factor)
    q = torch.cat(qs[::-1], dim=-1)
    r = rem[..., nf - (nd - 1):] if nd > 1 else FR.zeros((1,), f.device)
    return q, r


class Polynomial:
    """Dense polynomial over Fr with an explicitly tracked degree (reference
    polynomial.rs:49-165, 295-300)."""

    def __init__(self, coeffs: torch.Tensor, degree: int | None = None):
        if coeffs.dim() != 2 or coeffs.shape[0] != FR.W or coeffs.dtype != torch.int32:
            raise ValueError(f"coefficients must be int32 ({FR.W}, n) words")
        self.coeffs = coeffs
        self.degree = coeffs.shape[-1] - 1 if degree is None else degree
        if not 0 <= self.degree < coeffs.shape[-1]:
            raise ValueError(f"degree {self.degree} outside {coeffs.shape[-1]} coefficients")

    # ---- constructors (polynomial.rs:49-92 parity) ---------------------------

    @classmethod
    def from_ints(cls, ints, degree: int | None = None, device=None):
        if len(ints) == 0:
            ints = [0]
        c = torch.from_numpy(FR.encode(ints)).to(resolve_device(device))
        if degree is None:
            degree = len(ints) - 1
            while degree > 0 and ints[degree] == 0:
                degree -= 1
        return cls(c, degree)

    @classmethod
    def new_zero(cls, device=None):
        return cls(FR.zeros((1,), device), 0)

    @classmethod
    def from_scalar(cls, scalar, device=None):
        """Constant polynomial (polynomial.rs:56-61): an int or an (8, 1)
        word tensor."""
        if isinstance(scalar, int):
            return cls(torch.from_numpy(FR.encode([scalar])).to(resolve_device(device)), 0)
        return cls(scalar, 0)

    @classmethod
    def new_zero_with_size(cls, n: int, device=None):
        return cls(FR.zeros((n,), device), 0)

    @classmethod
    def new_monic_of_degree(cls, degree: int, device=None):
        """All-ones polynomial of the given degree (polynomial.rs:63-70)."""
        return cls(FR.one((degree + 1,), device), degree)

    @classmethod
    def new_single_term(cls, degree: int, device=None):
        c = FR.zeros((degree + 1,), device)
        c[:, degree] = FR.one((), device)
        return cls(c, degree)

    # ---- bookkeeping (polynomial.rs:94-155 parity) ---------------------------

    @property
    def device(self):
        return self.coeffs.device

    def num_coeffs(self) -> int:
        return self.degree + 1

    def is_zero(self) -> bool:
        return bool(FR.is_zero(self.coeffs).all())

    def trimmed(self) -> torch.Tensor:
        """Coefficients truncated to num_coeffs."""
        return self.coeffs[:, : self.degree + 1]

    def _last_nonzero(self, c: torch.Tensor) -> int:
        idx = torch.nonzero(~FR.is_zero(c)).reshape(-1)
        return int(idx[-1]) if idx.numel() else 0

    def fixup_degree(self):
        """Sync the tracked degree down past leading zeros (device -> host;
        polynomial.rs:108-125)."""
        self.degree = self._last_nonzero(self.coeffs)
        return self

    def shrink_degree(self):
        """Like fixup_degree, scanning only up to the tracked degree
        (polynomial.rs:117-120)."""
        self.degree = self._last_nonzero(self.trimmed())
        return self

    def truncate(self, degree: int):
        """Drop the terms above `degree` (polynomial.rs:107-110); returns a
        new Polynomial, the degree clamped to the stored coefficients."""
        new_len = min(degree + 1, self.coeffs.shape[-1])
        return Polynomial(self.coeffs[:, :new_len], new_len - 1)

    def reverse(self):
        """rev(f)(X) = X^deg * f(1/X) (polynomial.rs:112-115)."""
        return Polynomial(torch.flip(self.trimmed(), dims=(-1,)), self.degree)

    def lead(self) -> int:
        """Leading coefficient as an int (polynomial.rs:127-129)."""
        return FR.decode(self.coeffs[:, self.degree:self.degree + 1])[0]

    def constant(self) -> int:
        """Constant term as an int (polynomial.rs:131-133)."""
        return FR.decode(self.coeffs[:, 0:1])[0]

    def to_ints(self):
        return FR.decode(self.trimmed())

    # ---- arithmetic ------------------------------------------------------------

    def __add__(self, other):
        n = max(self.num_coeffs(), other.num_coeffs())
        return Polynomial(FR.add(_pad_to(self.trimmed(), n), _pad_to(other.trimmed(), n)), n - 1)

    def __sub__(self, other):
        n = max(self.num_coeffs(), other.num_coeffs())
        return Polynomial(FR.sub(_pad_to(self.trimmed(), n), _pad_to(other.trimmed(), n)), n - 1)

    def __mul__(self, other):
        return self.best_mul(other)

    def scalar_mul(self, s):
        """Multiply by a scalar given as an int or an (8, 1) word tensor."""
        if isinstance(s, int):
            return Polynomial(FR.mul_const(self.coeffs, FR.encode([s])[:, 0]), self.degree)
        return Polynomial(FR.mul(self.coeffs, s), self.degree)

    def best_mul(self, other):
        """NTT multiplication at every size (the reference dispatches
        naive-vs-FFT at 128 coefficients, polynomial.rs:185-191)."""
        out_len = self.num_coeffs() + other.num_coeffs() - 1
        return Polynomial(_mul_ntt(self.trimmed(), other.trimmed(), out_len), out_len - 1)

    def naive_mul(self, other):
        c = _mul_naive(self.trimmed(), other.trimmed())
        return Polynomial(c, self.degree + other.degree)

    def eval(self, x):
        """Evaluate at one point: int -> int, or (8, 1) tensor -> (8, 1)."""
        with span("poly.eval"):
            if isinstance(x, int):
                pt = torch.from_numpy(FR.encode([x])).to(self.device)
                return FR.decode(_eval_many(self.trimmed(), pt))[0]
            return _eval_many(self.trimmed(), x)

    def eval_many(self, pts):
        """Evaluate at (8, k) points -> (8, k) (multi_eval parity,
        polynomial.rs:229-233). Large k on large polynomials goes through
        the remainder tree; otherwise Horner's rule at every point."""
        k = pts.shape[-1]
        if k >= 64 and self.num_coeffs() * k >= (1 << 22):
            from .subproduct import multi_eval_tree

            return multi_eval_tree(self, pts)
        return _eval_many(self.trimmed(), pts)

    def multi_eval(self, pts):
        """Reference name of eval_many (polynomial.rs:229-233)."""
        return self.eval_many(pts)

    def long_division(self, divisor):
        """(quotient, remainder or None): None iff the division is exact.
        Quotients longer than newton_div_threshold use reversal + Newton
        inverse (poly/newton.py), shorter ones the schoolbook loop."""
        nf, nd = self.num_coeffs(), divisor.num_coeffs()
        if nf - nd + 1 > get_config().newton_div_threshold:
            from .newton import newton_divmod

            q, r = newton_divmod(self.trimmed(), divisor.trimmed(), nf, nd)
        else:
            q, r = _long_division(self.trimmed(), divisor.trimmed(), nf, nd)
        qp = Polynomial(q, max(0, self.degree - divisor.degree))
        rp = Polynomial(r).fixup_degree()
        if rp.is_zero():
            return qp, None
        return qp, rp

    def div_by_linear(self, x: int, want_rem: bool = True):
        """Divide by (X - x); returns (quotient, remainder int or None).
        want_rem=False skips the device -> host read of the remainder.
        Above 2^(div_chunk_log + 1) coefficients the division runs chunk by
        chunk (`_div_by_linear_big`), as in the reference (`:465-473`)."""
        with span("poly.divide"):
            pt = torch.from_numpy(FR.encode([x])).to(self.device)
            chunk_log = get_config().div_chunk_log
            if self.num_coeffs() > (2 << chunk_log):
                q, rem = _div_by_linear_big(self.trimmed(), pt, chunk_log)
            else:
                q, rem = _div_by_linear(self.trimmed(), pt)
            qp = Polynomial(q[:, 0, :], max(0, self.degree - 1))
            return qp, (FR.decode(rem)[0] if want_rem else None)

    def __eq__(self, other):
        """Mathematical equality of the padded coefficients (tracked degrees
        may differ: add / sub do not fix the degree up)."""
        n = max(self.num_coeffs(), other.num_coeffs())
        return bool(FR.eq(_pad_to(self.trimmed(), n), _pad_to(other.trimmed(), n)).all())

    __hash__ = None

    def __repr__(self):
        return f"Polynomial(degree={self.degree})"


def op_tree(size: int, get_elem, op):
    """Balanced binary fold (reference op_tree, polynomial.rs:367-392)."""
    assert size > 0
    if size == 1:
        return get_elem(0)
    half = size // 2
    left = op_tree(half, get_elem, op)
    right = op_tree(size - half, lambda i: get_elem(half + i), op)
    return op(left, right)
