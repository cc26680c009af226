"""PeerDAS cell proofs (EIP-7594; consensus-specs,
`specs/fulu/polynomial-commitments-sampling.md`): a blob's extension to
twice its domain, cut into cells, one KZG multi-proof a cell by FK20, and
the batch verification of any set of cells. Every call takes a leading
axis of blobs.

Sizes, with the spec's n = FIELD_ELEMENTS_PER_BLOB = 4096 and l =
FIELD_ELEMENTS_PER_CELL = 64: a blob is n field elements, the evaluations
of its polynomial f (degree < n) over the n-th roots of unity in
bit-reversed order; the extension evaluates f over the 2n-th roots in
bit-reversed order, cut into 2n / l cells of l values. Roots come from the
generator 7, as `ntt.domain.compute_omega` takes them. Cell k holds the
values on the coset h_k <omega_l> (`coset_for_cell`), h_k = omega_2n^rev(k)
(rev over log2(2n / l) bits), and its proof is [q_k(s)]_1 with
q_k = (f - I_k) / (X^l - h_k^l), I_k the cell's interpolant.

Cells (`compute_cells`): the blob's iNTT (n points, after one gather to
natural order), then the odd coset omega_2n <omega_n> by one n-point NTT of
f_i omega_2n^i: in bit-reversed order the first n values of the extension
are the blob itself and the last n the odd coset's.

Proofs (FK20: Feist and Khovratovich, "Fast amortized KZG proofs", the
multi-reveal case). With m = n / l and f = sum_{j<l} X^j F_j(X^l),
q_k(s) = H(h_k^l), where H(Y) = sum_{u < m-1} h_u Y^u and

    h_u = sum_{j<l} sum_{t <= m-2-u} f_{j + l (u+1+t)} [s^(j + l t)]_1.

For each j that is a Toeplitz product of the column A_j[v] = f_{j + l v}
with the SRS vector S_j[t] = [s^(j + l t)]_1: the cyclic convolution of
size 2m of A_j, zero-padded, with B_j, B_j[i] = S_j[2m - 1 - i] for
m < i < 2m and infinity elsewhere, whose entries u < m - 1 are the terms
of h_u. So

  * once an SRS (`DAS.fk20_table`): the forward group NTTs of the l vectors
    B_j, times 1/(2m), and the comb table of those 2n fixed points
    (`msm.pippenger.comb_table`: the affine d 2^(4 w) P for the 64 4-bit
    windows w and the digits d = 1 .. 15, 2n x 960 entries of 96 bytes,
    755 MB at the spec's sizes);
  * per call, over all blobs at once (`compute_cells_and_kzg_proofs`): the
    scalar NTTs of size 2m of every blob's l columns (one `ntt_block`
    launch); the 2m MSMs of l terms a blob, one a frequency, on the fixed
    table (one comb launch over 2n lanes a blob, a mixed addition a
    non-zero digit and no doubling, then a tree of log2(l) K2 launches);
    one inverse group NTT of size 2m (the 1/(2m) is in the
    table), whose entries from m - 1 on are set to infinity; and one
    forward group NTT of size 2m left in its stages' bit-reversed order,
    which is the cells' order, since h_k^l = omega_2m^rev(k).

No step loops over cells or blobs in Python, so a call on 9 blobs launches
as many kernels as a call on one.

Verification (`verify_cell_kzg_proof_batch`, the spec's
`verify_cell_kzg_proof_batch_impl`): the challenge r is the spec's
SHA-256 over its domain tag and the inputs' bytes, on the host, with the
commitments deduplicated by their bytes; the aggregated interpolant
sum_k r^k I_k is one batched l-point iNTT of the cells, a product with
h_k^-j and r^k, and one sum; the equation's three MSMs (LL = sum r^k pi_k,
RLC + RLP = sum w_i C_i + sum r^k h_k^l pi_k, RLI = the interpolant's
commitment) are one `ladder_msm` call; and e(LL, [s^l]_2) = e(RLC - RLI +
RLP, [1]_2) is checked by `verify_batched_device` with h^Z = hs[l], or by
the host engine, as the verifiers choose theirs (`config.pairing_engine`).
"""

import functools
import hashlib

import torch

from ..compat.serialize import g1_compress
from ..config import get_config
from ..constants import R
from ..curve import G1, G2, cuda_ops, g1_from_device, g2_from_device
from ..fields import FR
from ..fields.cuda_field import bitrev_perm
from ..hostcrypto import multi_pairing_check
from ..msm.pippenger import SMALL_MSM_WINDOW, comb_table, ladder_msm, point_sum
from ..ntt import Domain
from ..ntt.domain import compute_omega
from ..ntt.group import group_ntt, scale_points
from ..oracle import ec_add, ec_neg
from ..trace import span
from .engines import verify_batched_device

FIELD_ELEMENTS_PER_BLOB = 4096
FIELD_ELEMENTS_PER_CELL = 64
RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = b"RCKZGCBATCH__V1_"


def _exp(n: int, what: str) -> int:
    e = n.bit_length() - 1
    if n < 1 or 1 << e != n:
        raise ValueError(f"{what} must be a power of two, got {n}")
    return e


class DAS:
    """The cell calls over one SRS (`KZGParams`, monomial, at least n G1
    and l + 1 G2 powers), for blobs of `blob_size` elements and cells of
    `cell_size`, on the SRS's device."""

    def __init__(self, params, blob_size: int = FIELD_ELEMENTS_PER_BLOB,
                 cell_size: int = FIELD_ELEMENTS_PER_CELL):
        exp_n, exp_l = _exp(blob_size, "blob size"), _exp(cell_size, "cell size")
        if not 1 <= exp_l < exp_n:
            raise ValueError(f"cell size {cell_size} must be in [2, {blob_size // 2}]")
        if params.n < blob_size or params.hs[0].shape[-1] <= cell_size:
            raise ValueError(f"the SRS needs {blob_size} G1 and {cell_size + 1} G2 powers")
        self.params = params
        self.n, self.l = blob_size, cell_size
        self.m = blob_size // cell_size
        self.cells = 2 * self.m  # CELLS_PER_EXT_BLOB, and the circulant's size
        self.dom_n, self.dom_l = Domain(exp_n), Domain(exp_l)
        self.dom_c = Domain(exp_n - exp_l + 1)
        dev = self.device = params.gs[0].device
        self._rev_n = torch.from_numpy(bitrev_perm(exp_n)).to(dev)
        self._rev_l = torch.from_numpy(bitrev_perm(exp_l)).to(dev)
        w2n = compute_omega(2 * blob_size)[0]
        self._twist = torch.from_numpy(Domain._powers(w2n, blob_size)).to(dev)  # omega_2n^i
        rev_c = bitrev_perm(self.dom_c.exp)
        shifts = [pow(w2n, int(rev_c[k]), R) for k in range(self.cells)]  # h_k
        self.shift_pows = [pow(h, cell_size, R) for h in shifts]  # h_k^l
        unshift = []  # h_k^-j, j < l, cell-major
        for h in shifts:
            unshift += Domain._powers(pow(h, -1, R), cell_size).T.tolist()
        self._unshift = torch.tensor(unshift, dtype=torch.int32, device=dev).T.reshape(
            FR.W, self.cells, cell_size).contiguous()
        self._keep = (torch.arange(self.cells, device=dev) < self.m - 1)  # H's coefficients

    # ---- FK20's set-up ---------------------------------------------------------------

    @functools.cached_property
    def fk20_table(self):
        """The comb table (rows, p_inf) of the 2n points NTT(B_j)[k] / (2m),
        point k l + j for frequency k and column j (`comb_table`). Built at
        its first use and kept: a verifier never builds it."""
        l, c2 = self.l, self.cells
        dev = self.device
        i = torch.arange(c2, device=dev)
        valid = i > self.m
        j = torch.arange(l, device=dev)[:, None]
        idx = torch.where(valid[None], j + l * (c2 - 1 - i)[None], 0).reshape(-1)  # (l, 2m)
        gx, gy, ginf = (t[..., idx] for t in self.params.gs)
        inf = ginf | ~valid.expand(l, c2).reshape(-1)
        pts = G1.select(inf, G1.infinity(inf.shape, dev), G1.from_affine(gx, gy))
        pts = tuple(t.reshape(t.shape[:-1] + (l, c2)) for t in pts)
        table = scale_points(G1, group_ntt(G1, pts, self.dom_c), pow(c2, -1, R))
        return comb_table(tuple(t.transpose(-1, -2).reshape(-1, l * c2) for t in table))

    # ---- the spec's calls ------------------------------------------------------------

    def _blobs(self, blobs):
        if blobs.dim() != 3 or blobs.shape[0] != FR.W or blobs.shape[-1] != self.n:
            raise ValueError(f"blobs must be (8, B, {self.n}) words, got {tuple(blobs.shape)}")
        return blobs

    def _extend(self, blobs):
        """(coefficients, cells) of (8, B, n) blobs: (8, B, n) and
        (8, B, 2n / l, l) Montgomery words."""
        coeffs = self.dom_n.intt(torch.index_select(blobs, -1, self._rev_n))
        twist = self._twist.reshape((FR.W,) + (1,) * (coeffs.dim() - 2) + (self.n,))
        odd = self.dom_n.ntt(FR.mul(coeffs, twist))
        ext = torch.cat([blobs, torch.index_select(odd, -1, self._rev_n)], dim=-1)
        return coeffs, ext.reshape(ext.shape[:-1] + (self.cells, self.l))

    def compute_cells(self, blobs):
        """The cells of each blob: (8, B, n) words in bit-reversed
        evaluation form -> (8, B, 2n / l, l) words."""
        with span("das.cells"):
            return self._extend(self._blobs(blobs))[1]

    def compute_cells_and_kzg_proofs(self, blobs):
        """(cells, proofs) of each blob: the cells as `compute_cells` gives
        them and the cells' proofs, a Jacobian G1 batch (B, 2n / l)."""
        self._blobs(blobs)
        with span("das.prove"):
            with span("das.cells"):
                coeffs, cells = self._extend(blobs)
            return cells, self._fk20(coeffs)

    def _fk20(self, coeffs):
        lead = tuple(coeffs.shape[1:-1])
        with span("das.fk20.columns"):
            cols = coeffs.reshape((FR.W,) + lead + (self.m, self.l)).transpose(-1, -2)
            a_hat = self.dom_c.ntt(torch.cat([cols, torch.zeros_like(cols)], dim=-1))
            scalars = FR.from_mont(a_hat.transpose(-1, -2).contiguous())  # (8, B, 2m, l)
        with span("das.fk20.msm"):
            h_hat = point_sum(G1, cuda_ops.fk20_comb(*self.fk20_table, scalars))
        with span("das.fk20.g1_fft"):
            h = group_ntt(G1, h_hat, self.dom_c, inverse=True, scale=False)
            h = G1.select(self._keep, h, G1.infinity(h[0].shape[1:], h[0].device))
            return group_ntt(G1, h, self.dom_c, bit_reversed=True)

    def verify_cell_kzg_proof_batch(self, commitments, cell_indices, cells, proofs) -> bool:
        """Whether every cell is the evaluation of its commitment's
        polynomial on its coset, as its proof claims: commitments and proofs
        are Jacobian G1 batches of N points (one commitment a cell, repeats
        allowed), cell_indices N ints below 2n / l in any order, cells
        (8, N, l) Montgomery words."""
        idx = [int(k) for k in cell_indices]
        count = len(idx)
        if (tuple(cells.shape) != (FR.W, count, self.l) or commitments[0].shape[-1] != count
                or proofs[0].shape[-1] != count):
            raise ValueError(f"{count} cells need (8, {count}, {self.l}) values, "
                             f"{count} commitments and {count} proofs")
        if any(not 0 <= k < self.cells for k in idx):
            raise ValueError(f"cell indices must be below {self.cells}")
        if not count:
            return True
        with span("das.verify"):
            return self._verify(commitments, idx, cells, proofs)

    def _verify(self, commitments, idx, cells, proofs) -> bool:
        count, dev = len(idx), cells.device
        pts = G1.to_affine(tuple(torch.cat([c, p], dim=-1) for c, p in zip(commitments, proofs)))
        encoded = [g1_compress(p) for p in g1_from_device(pts)]
        first = {}  # each distinct commitment's first cell
        for k, b in enumerate(encoded[:count]):
            first.setdefault(b, k)
        unique = list(first)
        slot = {b: i for i, b in enumerate(unique)}
        com_idx = [slot[b] for b in encoded[:count]]
        r = self._challenge(unique, com_idx, idx, FR.decode(cells), encoded[count:])
        r_pows = [1]
        for _ in range(count - 1):
            r_pows.append(r_pows[-1] * r % R)
        weights = [0] * len(unique)
        for k, i in enumerate(com_idx):
            weights[i] = (weights[i] + r_pows[k]) % R
        weighted = [rk * self.shift_pows[k] % R for rk, k in zip(r_pows, idx)]
        # sum_k r^k I_k: each cell's iNTT is I_k(h_k X); times h_k^-j, then r^k
        interp = self.dom_l.intt(torch.index_select(cells, -1, self._rev_l))
        interp = FR.mul(interp, self._unshift[:, torch.tensor(idx, device=dev)])
        rcol = torch.from_numpy(FR.encode(r_pows)).to(dev)[..., None]
        agg = FR.sum_last(FR.mul(interp, rcol).transpose(-1, -2).contiguous())  # (8, l)
        # LL, RLC + RLP and RLI over the lanes [proofs | commitments | SRS powers < l]
        coms = torch.tensor(list(first.values()), device=dev)
        lanes = tuple(torch.cat([p[..., count:], p[..., coms], g[..., :self.l]], dim=-1)
                      for p, g in zip(pts, self.params.gs))
        width = lanes[0].shape[-1]
        zeros = [0] * (len(unique) + self.l)
        host = torch.from_numpy(FR.encode(r_pows + zeros + weighted + weights + [0] * self.l))
        scalars = torch.cat([host.to(dev).reshape(FR.W, 2, width),
                             torch.cat([FR.zeros((width - self.l,), dev), agg], -1)[:, None]],
                            dim=1)
        base = G1.select(lanes[2], G1.infinity((width,), dev), G1.from_affine(*lanes[:2]))
        tx, ty, p_inf = G1.ladder_table(base, SMALL_MSM_WINDOW)
        sums = ladder_msm(G1, (tx.unsqueeze(2).expand(tx.shape[:2] + (3, width)),
                               ty.unsqueeze(2).expand(ty.shape[:2] + (3, width)),
                               p_inf.expand(3, width)), FR.from_mont(scalars))
        ll, rlc_rlp, rli = (tuple(t[..., i] for t in sums) for i in range(3))
        return self._pairing(ll, rlc_rlp, rli)

    def _challenge(self, commitments, com_idx, idx, values, proofs) -> int:
        """The spec's `compute_verify_cell_kzg_proof_batch_challenge`."""
        h = hashlib.sha256(RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN)
        for v in (self.n, self.l, len(commitments), len(idx)):
            h.update(v.to_bytes(8, "big"))
        for c in commitments:
            h.update(c)
        for k, (i, cell) in enumerate(zip(com_idx, idx)):
            h.update(i.to_bytes(8, "big") + cell.to_bytes(8, "big"))
            h.update(b"".join(v.to_bytes(32, "big") for v in values[k * self.l:(k + 1) * self.l]))
            h.update(proofs[k])
        return int.from_bytes(h.digest(), "big") % R

    def _pairing(self, ll, rlc_rlp, rli) -> bool:
        """e(LL, [s^l]_2) == e(RLC + RLP - RLI, [1]_2)."""
        hs = self.params.hs
        engine = get_config().pairing_engine
        if engine == "device":
            hz = G2.from_affine(hs[0][..., self.l], hs[1][..., self.l])
            return verify_batched_device(self.params, rlc_rlp, ll, hz, rli)
        ll_h, a_h, b_h = g1_from_device(tuple(torch.stack([u, v, w], dim=-1)
                                              for u, v, w in zip(ll, rlc_rlp, rli)))
        h, s_l = g2_from_device(tuple(t[..., [0, self.l]] for t in hs))
        return multi_pairing_check([(ll_h, s_l), (ec_neg(ec_add(a_h, ec_neg(b_h))), h)],
                                   engine=engine)


__all__ = ["DAS", "FIELD_ELEMENTS_PER_BLOB", "FIELD_ELEMENTS_PER_CELL"]
