"""The check's control and its planted faults: each drives a whole run of a
cell (at a small size, on the CPU, the harness's look for a card skipped)
with the timed path broken underneath, and the check must come out not
correct; the reference in the program's place, unbroken, comes out
correct. On the card, `python3 -m kzgbench.control` runs the same at the
cells' own sizes."""

import pytest
import torch

from conftest import SMALL, run_small, small_cell

from kzgbench.control import system_for
from kzgbench.faults import FAULTS, Faulty
from kzgbench.reference.system import ReferenceSystem

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", list(SMALL))
def test_reference_in_the_programs_place_is_correct(bench, cell):
    out = run_small(bench, cell, ReferenceSystem(CPU))
    assert out["correct"] and out["attempted"] >= 5
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(bench, cell):
    system = system_for(small_cell(bench, cell), "control", CPU, ".")
    out = run_small(bench, cell, system)
    assert not out["correct"]
    bad = {k: c["value"] for k, c in out["checks"].items() if c["value"] > c["limit"]}
    # the narrow scalars reach the SRS and every answer the cell compares
    assert "srs_mismatches" in bad and len(bad) >= 2


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", list(SMALL))
def test_fault_is_not_correct(bench, cell, fault):
    out = run_small(bench, cell, Faulty(ReferenceSystem(CPU), fault), seconds=1.0)
    assert out["attempted"] >= 5
    assert not out["correct"], out["checks"]
