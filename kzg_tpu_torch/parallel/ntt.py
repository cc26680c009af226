"""Distributed four-step NTT over one mesh axis (port of
`kzg_tpu/parallel/ntt.py`).

    n = R * C,  R = ranks on the axis. x flat, block-split over the ranks.
    Viewing M[j1, j2] = x[j1*C + j2] (rows j1 = rank blocks):

      T0  all_to_all transpose: rank d holds M[:, d*C/R : (d+1)*C/R]
      A   local R-point NTT along j1 (root omega^C)     -> A[k1, j2]
      TW  twiddle A[k1, j2] *= omega^(j2*k1)
      T1  all_to_all transpose back: rank d holds row k1 = d
      B   local C-point NTT along j2 (root omega^R)     -> Y[k1, k2]

    y[k1 + R*k2] = Y[k1, k2], so the natural output is "transposed order"
    (rank d holds y at indices d + R*k2, exactly as in the JAX package); a
    third all_to_all and a local transpose give the standard flat order.
    The inverse that consumes transposed order is the mirror
    decimation-in-time pipeline (B' -> row twiddle -> transpose -> A' ->
    transpose), `four_step_dit`.

Every all_to_all is the same exchange: (8, R, C/R) words, slice s sent to
rank s, and slice s of the result received from rank s
(`dist.all_to_all_single` over dim 0, so the word axis is moved behind the
rank axis first). The local transforms are the port's `Domain` (kernel K5's
`ntt_block`); a 1-point domain (R = 1) is the identity and launches
nothing. The rank is a host integer, so the powers omega^d, g^(d C) and
the like are host constants and each table is a `field_scan` row of
powers times one of them (`geom_row`).
"""

import torch
import torch.distributed as dist

from ..constants import FR_GENERATOR, FR_ROOT_OF_UNITY, FR_TWO_ADICITY, R as FR_MOD
from ..fields import FR
from ..ntt import Domain
from .runtime import MeshAxis, block, mesh_axis


def geom_row(base: int, start: int, count: int, device) -> torch.Tensor:
    """(8, count) Montgomery row start * base^i, i < count: one
    `field_scan` row of powers base^1 .. base^count times the host constant
    start / base (base is a nonzero field element)."""
    col = torch.from_numpy(FR.encode([base])[:, 0]).to(device)
    scale = start * pow(base, -1, FR_MOD) % FR_MOD
    return FR.mul_const(FR.powers(col, count), FR.encode([scale])[:, 0])


def _block_twiddle(omega: int, r: int, c_local: int, rank: int, device) -> torch.Tensor:
    """(8, r, c_local) table of omega^(k1 * j2) over this rank's j2 block
    [rank * c_local, (rank + 1) * c_local): row k1 is a geometric row of
    ratio omega^k1."""
    return torch.stack([
        geom_row(pow(omega, k1, FR_MOD), pow(omega, k1 * rank * c_local, FR_MOD), c_local,
                 device)
        for k1 in range(r)], dim=1)


def exchange(m: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """(8, R, c) -> (8, R, c): slice s of the result is rank s's slice
    [this rank] (jax.lax.all_to_all with tiled=False, split and concat on
    the rank axis)."""
    send = m.transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return recv.transpose(0, 1)


def _local_ntt_axis(dom: Domain, x: torch.Tensor, dim: int, inverse: bool) -> torch.Tensor:
    x = x.movedim(dim, -1)
    x = dom.intt(x) if inverse else dom.ntt(x)
    return x.movedim(-1, dim)


def _split(exp: int, n_dev: int):
    n = 1 << exp
    r = n_dev
    log_r = (r - 1).bit_length()
    if 1 << log_r != r:
        raise ValueError("device count must be a power of two")
    c = n // r
    c_local = c // r
    if c_local * r != c or c_local == 0:
        raise ValueError(f"need n >= n_dev^2: 2^{exp} over {n_dev} ranks")
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_TWO_ADICITY - exp), FR_MOD)
    return n, r, log_r, c, c_local, omega


def prebuild_domains(exp: int, n_dev: int):
    """The two local domains of the four-step (JAX builds them outside its
    traces; here it only warms `Domain`'s cache)."""
    log_r = (n_dev - 1).bit_length()
    return Domain(log_r), Domain(exp - log_r)


def four_step_dif(x_local, exp: int, axis: MeshAxis, inverse: bool = False,
                  order: str = "standard"):
    """Forward-structured (decimation-in-frequency) distributed transform of
    this rank's standard-order block x_local (8, n / R). Output in `order`:
    "standard" (three exchanges) or "transposed" (two)."""
    n, r, log_r, c, c_local, omega = _split(exp, axis.size)
    if inverse:
        omega = pow(omega, -1, FR_MOD)
    dom_r, dom_c = prebuild_domains(exp, r)

    m = exchange(x_local.reshape(FR.W, r, c_local), axis)  # T0: M[j1, j2 in block d]
    m = _local_ntt_axis(dom_r, m, 1, inverse)  # A
    m = FR.mul(m, _block_twiddle(omega, r, c_local, axis.rank, m.device))  # TW
    m = exchange(m, axis).reshape(FR.W, c)  # T1: A'[k1 = d, all j2]
    m = dom_c.intt(m) if inverse else dom_c.ntt(m)  # B: Y[k1 = d, k2]
    if order == "transposed":
        return m
    m = exchange(m.reshape(FR.W, r, c_local), axis)  # T2: [k1, k2_local]
    return m.transpose(1, 2).reshape(FR.W, c)  # local flat = k2_local * R + k1


def four_step_dit(y_local, exp: int, axis: MeshAxis, inverse: bool = True):
    """Mirror (decimation-in-time) transform CONSUMING transposed order and
    emitting standard order (two exchanges). With inverse=True this is the
    exact inverse of four_step_dif(..., order="transposed"):

        x[j1 C + j2] = (1/n) sum_{k1} w^{-j1 C k1} w^{-j2 k1}
                        [ sum_{k2} y[k1 + R k2] w^{-R j2 k2} ]
    """
    n, r, log_r, c, c_local, omega = _split(exp, axis.size)
    if inverse:
        omega = pow(omega, -1, FR_MOD)
    dom_r, dom_c = prebuild_domains(exp, r)

    m = dom_c.intt(y_local) if inverse else dom_c.ntt(y_local)  # B': B[k1 = d, j2]
    m = FR.mul(m, geom_row(pow(omega, axis.rank, FR_MOD), 1, c, m.device))  # omega^(j2 d)
    m = exchange(m.reshape(FR.W, r, c_local), axis)  # [k1, j2 in block d]
    m = _local_ntt_axis(dom_r, m, 1, inverse)  # A': x[j1, j2 block]
    return exchange(m, axis).reshape(FR.W, c)  # T0^-1: x[d*C + j2]


def coset_scale_local(x_local, exp: int, axis: MeshAxis, inverse: bool):
    """x_local times g^j (g^-j) at global flat index j = d * (n / R) +
    local: the sharded distribute_powers (reference ft.rs:142-178)."""
    blk = (1 << exp) // axis.size
    g = pow(FR_GENERATOR, -1, FR_MOD) if inverse else FR_GENERATOR
    return FR.mul(x_local, geom_row(g, pow(g, axis.rank * blk, FR_MOD), blk, x_local.device))


class ShardedDomain:
    """Sharded evaluation domain of 2^exp points over one mesh axis.

    ntt / intt / coset_ntt / coset_intt map this rank's standard-order block
    (8, n / R) to its standard-order block of the result, as `Domain` does
    for the whole array. The transposed-order variants (ntt_t / intt_t and
    coset_*_t) skip the last / first exchange, for pointwise pipelines.
    `shard(arr)` cuts this rank's block out of a replicated array."""

    def __init__(self, mesh, axis_name: str, exp: int):
        self.mesh = mesh
        self.axis_name = axis_name
        self.exp = exp
        self.d = 1 << exp
        self.axis = a = mesh_axis(mesh, axis_name)
        self.n_dev = a.size
        _split(exp, a.size)
        prebuild_domains(exp, a.size)

        self.ntt = lambda x: four_step_dif(x, exp, a, False, "standard")
        self.intt = lambda x: four_step_dif(x, exp, a, True, "standard")
        self.ntt_t = lambda x: four_step_dif(x, exp, a, False, "transposed")
        self.intt_t = lambda x: four_step_dit(x, exp, a, True)
        self.coset_ntt = lambda x: four_step_dif(
            coset_scale_local(x, exp, a, False), exp, a, False, "standard")
        self.coset_intt = lambda x: coset_scale_local(
            four_step_dif(x, exp, a, True, "standard"), exp, a, True)
        self.coset_ntt_t = lambda x: four_step_dif(
            coset_scale_local(x, exp, a, False), exp, a, False, "transposed")
        self.coset_intt_t = lambda x: coset_scale_local(
            four_step_dit(x, exp, a, True), exp, a, True)

    def shard(self, arr):
        """This rank's block of a replicated (8, n) array, on its device."""
        return block(arr, self.axis)
