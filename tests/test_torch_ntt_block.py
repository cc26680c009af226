"""K5 as a block transform (`cuda_field.ntt_block`, its plain twin on the
CPU) and the card's NTT route built on it (`ntt.domain.Domain`), against
the JAX package on the same numpy-seeded inputs. NTT outputs are canonical
Montgomery words, so the comparison is exact (tolerance 0), limb for limb.

  * `ntt_block_plain` (all stages, natural order, 1/m as a post scale for
    the inverse) against `kzg_tpu`'s `Domain(e)._ntt_axis2`: e = 1..8,
    bt in {1, 3}, nb in {1, 2}, both directions;
  * the Domain on CPU tensors (the ntt_block route) against JAX's ntt,
    intt, coset_ntt and coset_intt: with BLOCK_MAX_EXP lowered so that the
    four-step composition (e <= 2T) and its recursion (e > 2T) run at
    e = 5..10, and at e = 13, above the default T = 12
    (test_torch_ntt_block_route.py, a file of its own so that a parallel
    run gives it a worker);
  * inputs 0, 1 and r - 1, and the domains d = 1 and 2;
  * ntt_block calls a transform: at most 1 for e <= T, at most 3 for
    T < e <= 2T, and the scales fused (no other field op);
  * the pre and post scales (dense and split tables, the product mode with
    a column divisor) and the transposed store against host integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.ntt import domain as jdomain
from kzg_tpu_torch import config, kernels
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.fields import FR, cuda_field
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.ntt import Domain
from kzg_tpu_torch.ntt import domain as pdomain


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port places tensors on the card by default; these tests run its
    plain twins, so they ask for the CPU."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)  # the twins' ops are tiny; test files run side by side
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _ints(seed, n):
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    vals[:3] = [0, 1, R - 1][:n]
    return vals


def _both(ints, shape):
    """The same Fr values as port words (8, *shape) and JAX limbs (16, *shape)."""
    port = torch.from_numpy(FR.encode(ints)).reshape((FR.W,) + shape)
    jax = jnp.asarray(JFR.encode(ints)).reshape((JFR.L,) + shape)
    return port, jax


def _same(port, jax):
    np.testing.assert_array_equal(unpack16(port).numpy().astype(np.uint32), np.asarray(jax))


def _transforms(dom):
    return (dom.ntt, dom.intt, dom.coset_ntt, dom.coset_intt)


@pytest.fixture
def counted(monkeypatch):
    """ntt_block's calls, counted (on the CPU the wrapper counts no launch)."""
    calls = []
    real = cuda_field.ntt_block

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(cuda_field, "ntt_block", counting)
    return calls


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("bt", [1, 3])
@pytest.mark.parametrize("exp", list(range(1, 9)))
def test_ntt_block_plain_matches_jax_axis2(exp, bt, nb):
    dom, jdom = Domain(exp), jdomain.Domain(exp)
    x, jx = _both(_ints(100 + exp, nb * dom.d * bt), (nb, dom.d, bt))
    dinv = dom._scale("dinv_scale", "cpu", "const", 0, dom.d_inv)
    for inverse in (False, True):
        got = cuda_field.ntt_block_plain(x, dom._stage_table(inverse, "cpu"),
                                         post=dinv if inverse else None)
        _same(got, jdom._ntt_axis2(jx, inverse))


@pytest.mark.parametrize("exp", [0, 1, 2])
def test_domain_route_edges_and_small_domains(counted, exp):
    """d = 1, 2 and 4 with 0, 1 and r - 1 among the inputs, batched; one
    call a transform (none for d = 1)."""
    dom, jdom = Domain(exp), jdomain.Domain(exp)
    x, jx = _both(_ints(300 + exp, 3 * dom.d), (3, dom.d))
    for f, jf in zip(_transforms(dom), _transforms(jdom)):
        counted.clear()
        _same(f(x), jf(jx))
        assert len(counted) == (0 if exp == 0 else 1)


@pytest.mark.parametrize("exp,block_max,most", [(6, 6, 1), (8, 4, 3), (12, 12, 1), (14, 7, 3),
                                                (20, 12, 3)])
def test_calls_per_transform(monkeypatch, exp, block_max, most):
    """At most one ntt_block call up to 2^T points and three up to 2^2T,
    the scales fused: no other field op runs (shapes only: the field ops
    are replaced by stubs that record and return zeros)."""
    monkeypatch.setattr(pdomain, "BLOCK_MAX_EXP", block_max)
    calls, other = [], []

    def fake_block(x, tw, pre=None, post=None, out_bt=None, cols=None, threads=None):
        calls.append((tuple(x.shape), out_bt))
        W, nb, m, bt = x.shape
        return torch.zeros((W, nb * bt // (out_bt or bt), m, out_bt or bt), dtype=torch.int32)

    monkeypatch.setattr(cuda_field, "ntt_block", fake_block)
    monkeypatch.setattr(cuda_field, "binary", lambda *a: other.append(a) or a[2])
    monkeypatch.setattr(cuda_field, "mul_const", lambda *a: other.append(a) or a[1])
    dom = Domain(exp)
    x = torch.zeros((FR.W, dom.d), dtype=torch.int32)
    for f in _transforms(dom):
        calls.clear()
        f(x)
        assert 1 <= len(calls) <= most and not other, (f.__name__, calls, len(other))


def test_scales_and_transposed_store_against_host_ints():
    """ntt_block_plain's pre scale (split tables), post scale (product mode,
    column divisor 2) and out_bt, against the DFT on host integers."""
    exp, bt, div = 3, 4, 2
    m = 1 << exp
    top = Domain(exp + 2)  # the post scale's base: a 32nd root of unity
    pre = cuda_field.NttScale("linear", torch.from_numpy(
        np.ascontiguousarray(FR.encode([pow(5, i, R) for i in range(4)]).T)),
        torch.from_numpy(np.ascontiguousarray(FR.encode([pow(5, 4 * i, R) for i in range(8)]).T)),
        s=2)
    post = cuda_field.NttScale("product", torch.from_numpy(
        np.ascontiguousarray(FR.encode([pow(top.omega, i, R) for i in range(m * bt)]).T)),
        div=div)
    vals = _ints(400, 2 * m * bt)
    x = torch.from_numpy(FR.encode(vals)).reshape(FR.W, 2, m, bt)
    got = cuda_field.ntt_block_plain(x, Domain(exp)._stage_table(False, "cpu"), pre, post,
                                     out_bt=2 * bt)
    assert got.shape == (FR.W, 1, m, 2 * bt)
    dec = FR.decode(got.reshape(FR.W, -1))
    w = Domain(exp).omega
    for b in range(2):
        for c in range(bt):
            col = [vals[(b * m + j) * bt + c] * pow(5, j * bt + c, R) % R for j in range(m)]
            for k in range(m):
                want = sum(v * pow(w, j * k, R) for j, v in enumerate(col)) % R
                q = b * bt + c
                want = want * pow(top.omega, k * ((q % (2 * bt)) // div), R) % R
                assert dec[k * 2 * bt + q] == want, (b, c, k)


def test_ntt_block_refuses_bad_shapes():
    x = torch.zeros((FR.W, 1, 8, 1), dtype=torch.int32)
    tw = Domain(3)._stage_table(False, "cpu")
    for bad in (lambda: cuda_field.ntt_block(x[:, :, :6], tw[:6]),
                lambda: cuda_field.ntt_block(x, tw[:4]),
                lambda: cuda_field.ntt_block(x, tw, out_bt=3),
                lambda: cuda_field.ntt_block(torch.zeros((FR.W, 1, 1 << 13, 1), dtype=torch.int32),
                                             torch.zeros((1 << 13, 8), dtype=torch.int32))):
        with pytest.raises(kernels.KernelError):
            bad()
