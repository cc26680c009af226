"""The card's NTT route (`ntt.domain.Domain` on K5's block transform, its
plain twin on the CPU) against the JAX package's ntt, intt, coset_ntt and
coset_intt, limb for limb, with BLOCK_MAX_EXP lowered so that the
four-step composition (e <= 2T) and its recursion (e > 2T) run at
e = 5..10, and at e = 13, above the default T = 12; ntt_block's calls a
transform counted. The route cases of test_torch_ntt_block.py, a file of
their own so that a parallel run gives the two halves two workers (the
JAX transforms at 2^13 compile for about two minutes on a CPU).

Tolerance 0: exact integer arithmetic. Inputs from numpy seeds.
"""

import pytest

from kzg_tpu.ntt import domain as jdomain
from kzg_tpu_torch.ntt import Domain
from kzg_tpu_torch.ntt import domain as pdomain

from test_torch_ntt_block import _cpu_device, _both, _ints, _same, _transforms, counted  # noqa: F401


@pytest.mark.parametrize("exp,block_max", [(5, 2), (6, 3), (7, 2), (8, 4), (9, 3), (10, 5),
                                           (13, 12)])
def test_domain_route_matches_jax(monkeypatch, counted, exp, block_max):
    """The ntt_block route with T = block_max: four-step at e <= 2T (two
    calls), recursion above (e = 5 at T = 2, 7 at 2, 9 at 3)."""
    monkeypatch.setattr(pdomain, "BLOCK_MAX_EXP", block_max)
    dom, jdom = Domain(exp), jdomain.Domain(exp)
    x, jx = _both(_ints(200 + exp, dom.d), (dom.d,))
    for f, jf in zip(_transforms(dom), _transforms(jdom)):
        counted.clear()
        _same(f(x), jf(jx))
        if exp <= 2 * block_max:
            assert len(counted) == 2
