"""Kernel K4 over Fp2 on the CPU: the plain twin and K4's program against
the JAX package's G2 `window_join`, word for word, at the join's edge cases
(`bench.horner.CASES`; see test_torch_horner.py, which holds the same for
G1). A file of its own so that a parallel run can give it a worker: each
JAX G2 join traces and compiles for about a minute on a CPU.

Tolerance 0: exact integer arithmetic. Inputs from numpy seeds.
"""

import pytest
import torch

from kzg_tpu_torch import config
from kzg_tpu_torch.bench import horner as hbench

from test_torch_horner import check_edge_case


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """The port's twins on the CPU, one intra-op thread (as in
    test_torch_horner.py)."""
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


@pytest.mark.parametrize("case", list(hbench.CASES))
def test_horner_join_g2_edge_cases_match_jax(case):
    check_edge_case("g2", case)
