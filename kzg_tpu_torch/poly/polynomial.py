"""Dense polynomials over Fr: the subset of `kzg_tpu/poly/polynomial.py`
that the coefficient-form single opening runs.

Coefficients are an (8, n) int32 tensor of Montgomery Fr words (word axis
leading, coefficient index on the batch axis) with the degree tracked as a
host int. The prefix scans and `batch_inv` behind evaluation and linear
division were XLA, not Pallas, in the JAX package; here they are plain
tensor code whose field math runs on kernel K1 for CUDA tensors.
"""

import torch

from ..fields import FR


def _pad_to(c: torch.Tensor, n: int) -> torch.Tensor:
    if c.shape[-1] == n:
        return c
    return torch.nn.functional.pad(c, (0, n - c.shape[-1]))


def _eval_many(coeffs: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Evaluate one polynomial (8, n) at points (8, k) -> (8, k).

    Chunked power method (`kzg_tpu/poly/polynomial.py:93-118`): inner
    products against a power table of width c = min(4096, n), Horner in x^c
    over the chunks, high to low."""
    n = coeffs.shape[-1]
    k = pts.shape[-1]
    c = min(4096, n)
    npad = -(-n // c) * c
    coeffs = _pad_to(coeffs, npad)
    base = pts[..., None].expand(FR.W, k, c)
    pw = FR.prefix_mul(base)  # pts^1 .. pts^c
    powers = torch.cat([FR.one((k, 1), pts.device), pw[..., : c - 1]], dim=-1)
    x_c = pw[..., c - 1]
    acc = FR.zeros((k,), pts.device)
    for j in range(npad // c - 1, -1, -1):
        chunk = coeffs[:, j * c:(j + 1) * c]
        inner = FR.sum_last(FR.mul(chunk[:, None, :], powers))
        acc = FR.add(FR.mul(acc, x_c), inner)
    return acc


def _div_by_linear(f: torch.Tensor, x: torch.Tensor):
    """Quotient and remainder of f / (X - x), x of shape (8, k)
    (`kzg_tpu/poly/polynomial.py:121-145`).

    q_j = sum_{i>j} f_i x^{i-j-1} = xinv^{j+1} * suffix_sum(f_i x^i)_{j+1},
    log-depth; the x == 0 column falls back to a coefficient shift.
    Returns (8, k, n-1) quotients and (8, k) remainders f(x)."""
    n = f.shape[-1]
    k = x.shape[-1]
    xb = x[..., None].expand(FR.W, k, n)
    pw = FR.prefix_mul(xb)  # x^1 .. x^n
    powx = torch.cat([FR.one((k, 1), x.device), pw[..., : n - 1]], dim=-1)
    t = FR.mul(f[:, None, :], powx)  # f_i x^i
    s = FR.prefix_add(t, reverse=True)  # inclusive suffix sums
    rem = s[..., 0]
    xinv = FR.batch_inv(x)
    pwinv = FR.prefix_mul(xinv[..., None].expand(FR.W, k, n - 1))
    q = FR.mul(s[..., 1:], pwinv)
    zero = FR.is_zero(x)[None, :, None]
    q = torch.where(zero, f[:, None, 1:].expand_as(q), q)
    return q, rem


class Polynomial:
    """Dense polynomial over Fr with an explicitly tracked degree."""

    def __init__(self, coeffs: torch.Tensor, degree: int | None = None):
        if coeffs.dim() != 2 or coeffs.shape[0] != FR.W or coeffs.dtype != torch.int32:
            raise ValueError(f"coefficients must be int32 ({FR.W}, n) words")
        self.coeffs = coeffs
        self.degree = coeffs.shape[-1] - 1 if degree is None else degree
        if not 0 <= self.degree < coeffs.shape[-1]:
            raise ValueError(f"degree {self.degree} outside {coeffs.shape[-1]} coefficients")

    @classmethod
    def from_ints(cls, ints, degree: int | None = None, device=None):
        if len(ints) == 0:
            ints = [0]
        c = torch.from_numpy(FR.encode(ints)).to(device)
        if degree is None:
            degree = len(ints) - 1
            while degree > 0 and ints[degree] == 0:
                degree -= 1
        return cls(c, degree)

    @property
    def device(self):
        return self.coeffs.device

    def num_coeffs(self) -> int:
        return self.degree + 1

    def trimmed(self) -> torch.Tensor:
        """Coefficients truncated to num_coeffs."""
        return self.coeffs[:, : self.degree + 1]

    def to_ints(self):
        return FR.decode(self.trimmed())

    def eval(self, x):
        """Evaluate at one point: int -> int, or (8, 1) tensor -> (8, 1)."""
        if isinstance(x, int):
            pt = torch.from_numpy(FR.encode([x])).to(self.device)
            return FR.decode(_eval_many(self.trimmed(), pt))[0]
        return _eval_many(self.trimmed(), x)

    def div_by_linear(self, x: int, want_rem: bool = True):
        """Divide by (X - x); returns (quotient, remainder int or None).
        want_rem=False skips the device -> host read of the remainder."""
        pt = torch.from_numpy(FR.encode([x])).to(self.device)
        q, rem = _div_by_linear(self.trimmed(), pt)
        qp = Polynomial(q[:, 0, :], max(0, self.degree - 1))
        return qp, (FR.decode(rem)[0] if want_rem else None)

    def __repr__(self):
        return f"Polynomial(degree={self.degree})"
