"""The cells on the card, at their own sizes, for a short window: each
comes out correct with its metrics. Marked `cuda`; skips without a card
(the decision is made in the fixture)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", list(SMALL))
def test_cell_on_the_card(card, bench, cell, trace):
    res = subprocess.run([sys.executable, "-m", "kzgbench.run", "--workload", cell, "--seed",
                          str(2**34 + 3 + trace), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    names = [m["name"] for m in bench["per_layer" if trace else "end_to_end"]
             if cell in m.get("workloads", [cell])]
    assert set(out["metrics"]) == set(names)
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
