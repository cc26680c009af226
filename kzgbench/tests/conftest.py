"""Shared fixtures of the benchmark's tests: small copies of the cells, run
on the CPU with the reference in the program's place."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the small sizes every CPU run of a cell uses: the same code, few elements
SMALL = {
    "plonk_2e24.open": ({"coefficients": 256, "g1_powers": 256}, {"pool": 2}),
    "eip4844_blob.verify": ({"coefficients": 64, "g1_powers": 64, "g2_powers": 5}, {"pool": 6}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def small_cell(bench, name):
    from kzgbench import harness

    cell = harness.find_cell(bench, name)
    cfg, mix = SMALL[name]
    cell.config = {**cell.config, **cfg}
    cell.mix = {**cell.mix, **mix}
    return cell


def run_small(bench, name, system, seed=2**33 + 5, seconds=0.6, trace=False):
    import time

    from kzgbench import harness

    return harness.run_cell(small_cell(bench, name), seed, seconds, trace, system,
                            torch.device("cpu"), time.perf_counter())
