"""The streamed parts of the 2^24 single opening on the CPU, against the JAX
package and the oracle:

  * `_div_stream_chunk` (one `fr_horner` call a chunk) chained over 3-4
    chunks, high to low, equal word for word to the JAX package's
    `_div_stream_consts` / `_div_stream_chunk` chain, quotient chunks and
    carries;
  * `_div_by_linear_big` at chunk_log 4 equal to the JAX one, at n a
    multiple of the chunk and not, n one above a multiple, and x = 0; and
    `Polynomial.div_by_linear` switching to it above 2^(div_chunk_log + 1)
    coefficients with the same quotient as the one-shot division.

Tolerance 0: exact integer arithmetic. Inputs from numpy seeds. The
chunked MSM is in `test_torch_stream_msm.py` and the streamed witness in
`test_torch_stream_witness.py` (each ~30 s on the plain twins, so each has
a file of its own); the kernels run on the card in
`tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kzg_tpu.fields import FR as JFR
from kzg_tpu.poly import polynomial as jpoly
from kzg_tpu_torch import config
from kzg_tpu_torch.constants import R
from kzg_tpu_torch.fields import FR
from kzg_tpu_torch.fields.limb import unpack16
from kzg_tpu_torch.poly import Polynomial
from kzg_tpu_torch.poly import polynomial as pmod
from kzg_tpu_torch.poly.polynomial import _div_by_linear, _div_by_linear_big, _div_stream_chunk


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's plain versions on the CPU, one intra-op thread (the twins
    run many tiny ops)."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def _ints(seed, n):
    rs = np.random.default_rng(seed)
    vals = [int.from_bytes(rs.bytes(32), "little") % R for _ in range(n)]
    vals[:3] = [0, 1, R - 1][:n]
    return vals


def _words(ints):
    return torch.from_numpy(FR.encode(ints))


def _same(port_words, jax_limbs):
    got = unpack16(port_words).numpy().astype(np.uint32)
    want = np.asarray(jax_limbs)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunks", [3, 4])
def test_chunk_step_matches_jax_chain(chunks):
    chunk_log = 4
    m = 1 << chunk_log
    f_ints = _ints(chunks, chunks * m)
    x = _ints(100 + chunks, 4)[3]
    f, pt = _words(f_ints), _words([x])
    jf, jpt = jnp.asarray(JFR.encode(f_ints)), jnp.asarray(JFR.encode([x]))
    consts = jpoly._div_stream_consts(jpt, chunk_log)
    carry, jcarry = FR.zeros((1,), "cpu"), JFR.zeros(())
    for ci in range(chunks - 1, -1, -1):
        qc, carry = _div_stream_chunk(f[:, ci * m:(ci + 1) * m], pt, carry)
        jqc, jcarry = jpoly._div_stream_chunk(jf[:, ci * m:(ci + 1) * m], jcarry, *consts)
        _same(qc, jqc)
        _same(carry[:, 0], jcarry)
    # the last carry is f(x)
    assert FR.decode(carry)[0] == sum(c * pow(x, i, R) for i, c in enumerate(f_ints)) % R


@pytest.mark.parametrize("n,x_kind", [(64, "random"), (57, "random"), (49, "random"),
                                      (50, "zero")],
                         ids=["n64", "n57-ragged", "n49-one-above", "n50-x0"])
def test_div_by_linear_big_matches_jax(n, x_kind):
    f_ints = _ints(n, n)
    x = 0 if x_kind == "zero" else _ints(7 * n, 4)[3]
    f, pt = _words(f_ints), _words([x])
    q, rem = _div_by_linear_big(f, pt, 4)
    jq, jrem = jpoly._div_by_linear_big(jnp.asarray(JFR.encode(f_ints)),
                                        jnp.asarray(JFR.encode([x])), 4)
    _same(q, jq)
    _same(rem, jrem)
    # and the one-shot division's words
    q1, rem1 = _div_by_linear(f, pt)
    assert torch.equal(q, q1) and torch.equal(rem, rem1)


def test_div_by_linear_switches_above_the_chunk(monkeypatch):
    """div_chunk_log = 8: the chunked division from 513 coefficients, the
    same quotient and remainder as the one-shot division below the
    switch."""
    n = 600
    x = _ints(6, 4)[3]
    poly = Polynomial(_words(_ints(5, n)))
    want_q, want_rem = poly.div_by_linear(x)
    calls = []

    def spy(f, pt, chunk_log):
        calls.append(chunk_log)
        return _div_by_linear_big(f, pt, chunk_log)

    monkeypatch.setattr(pmod, "_div_by_linear_big", spy)
    old = config.get_config()
    try:
        config.configure(div_chunk_log=8)
        q, rem = poly.div_by_linear(x)
    finally:
        config.set_config(old)
    assert calls == [8]
    assert rem == want_rem and q == want_q and q.degree == n - 2
