"""The PeerDAS cell `peerdas_cells.prove` at a small size of its shape on
the CPU (the harness's look for a card skipped): the reference in the
program's place comes out correct, and the control and each planted fault
come out not correct. The PeerDAS calls reach the reference, the control
and the faults through `kzgbench/das.py`; its metric readers are checked
on synthetic runs whose answers are worked out by hand."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT

from kzgbench import das, harness, trace
from kzgbench.control import system_for
from kzgbench.faults import FAULTS, Faulty
from kzgbench.reference import das as ref
from kzgbench.reference.bls import G1, R
from kzgbench.reference.system import ReferenceSystem

CPU = torch.device("cpu")
MS = 1_000_000  # nanoseconds
# the deployment's shape at a small size: blob 64, cell 4, 32 cells, SRS of 64 G1 and 5 G2
SMALL = {
    "peerdas_cells.prove": ({"coefficients": 64, "g1_powers": 64, "g2_powers": 5, "cell": 4,
                             "cells": 32}, {"blobs": 3}),
}


def _cell(bench, name):
    cell = harness.find_cell(bench, name)
    cfg, mix = SMALL[name]
    cell.config = {**cell.config, **cfg}
    cell.mix = {**cell.mix, **mix}
    return cell


def _run(bench, name, system, seconds=0.6, trace_on=False):
    return harness.run_cell(_cell(bench, name), 2**33 + 21, seconds, trace_on, system, CPU,
                            time.perf_counter())


def test_cell_is_found_by_name(bench):
    cell = harness.find_cell(bench, "peerdas_cells.prove")
    assert cell.mix["kind"] == "cells" and cell.mix["blobs"] == 9 and cell.mix["pool"] == 2
    assert (cell.config["coefficients"], cell.config["cell"], cell.config["cells"]) == (4096, 64, 128)
    assert cell.config["g2_powers"] == 65 and cell.control == {"scalar_bits": 128}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "open_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "das.idle_ms", "das.syncs", "kernels.launches_per_blob", "das.fk20_roofline_pct",
        "setup.srs_s", "device.idle_pct.open"}


@pytest.mark.parametrize("cell", list(SMALL))
def test_reference_in_the_programs_place_is_correct(bench, cell):
    out = _run(bench, cell, ReferenceSystem(CPU))
    assert out["correct"] and out["attempted"] >= 3
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert {"setup_s", "open_s"} <= set(out["metrics"])


def test_cells_check_compares_every_cell_and_proof(bench):
    """The reference's prover, run beside the check's own closed forms,
    gives the spec's literal cells and long-division proofs."""
    cfg = SMALL["peerdas_cells.prove"][0]
    n, l, s = cfg["coefficients"], cfg["cell"], 0x1234567
    blob = [pow(5, i, R) * 11 % R for i in range(n)]
    ext, q = ref.Cells(s, n, l).blob(blob)
    assert ext == sum(ref.compute_cells(blob, l), [])
    coeffs = ref.polynomial_eval_to_coeff(blob)
    g = ref.FixedBase()
    srs = [g.mul(pow(s, i, R)) for i in range(n)]
    for k in (0, 7, 31):
        proof, ys = ref.compute_kzg_proof_multi_impl(coeffs, ref.coset_for_cell(k, n, l), srs)
        assert ys == ext[k * l:(k + 1) * l]
        assert G1.eq(proof, G1.mul(G1.gen, q[k]))


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(bench, cell):
    system = system_for(_cell(bench, cell), "control", CPU, ".")
    out = _run(bench, cell, system)
    assert not out["correct"]
    bad = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert "srs_mismatches" in bad and len(bad) >= 2


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", list(SMALL))
def test_fault_is_not_correct(bench, cell, fault):
    out = _run(bench, cell, Faulty(ReferenceSystem(CPU), fault), seconds=1.0)
    assert out["attempted"] >= 5
    assert not out["correct"], out["checks"]


def test_faults_reach_the_das_calls():
    """Each fault breaks what it names in the cell calls, on a block of two
    blobs: stale repeats the first outputs, half drops one blob's proofs,
    altered raises one value by 1 on the fifth call, lost raises on it."""
    n, l = 8, 2
    blocks = [torch.tensor([[b * 100 + i for i in range(2 * n)]] * 8,
                           dtype=torch.int32).reshape(8, 2, n) % 1000 for b in range(2)]
    cfg = {"coefficients": n, "cell": l}
    srs = {"s": 12345}
    outs = {}
    for fault in FAULTS:
        calls = das.calls_for(Faulty(ReferenceSystem(CPU), fault))
        prover = calls.prover(srs, cfg)
        got = []
        for k in range(5):
            try:
                got.append(calls.prove(prover, blocks[k % 2]))
            except RuntimeError:
                got.append(None)
        outs[fault] = (calls, got)
    honest = das.calls_for(ReferenceSystem(CPU))
    want = [honest.prove(honest.prover(srs, cfg), blocks[k % 2]) for k in range(2)]
    calls, got = outs["stale"]
    assert torch.equal(got[1]["cells"], want[0]["cells"])
    calls, got = outs["half"]
    assert len(calls.proof_bytes(got[0])) == len(honest.proof_bytes(want[0])) // 2
    calls, got = outs["altered"]
    diff = (got[4]["cells"] != want[0]["cells"]).any(dim=0)
    assert int(diff.sum()) == 1 and bool(diff.reshape(-1)[0])
    assert ref.values(got[4]["cells"][:, 0, 0, :1]) == [(ref.values(
        want[0]["cells"][:, 0, 0, :1])[0] + 1) % R]
    assert outs["lost"][1][4] is None and outs["lost"][1][3] is not None


def _das_trace():
    """A 100 ms window with two requests: `cells.prove` 0-40 and 50-90 ms,
    each around one `das.prove` (2-38, 52-88) holding `das.fk20.msm`; the
    device runs 5-20, 30-36 (first) and 55-85 (second), and 95-99 outside
    both; waits at 3, 10 (inside) and 45 (between)."""
    ops = [("ladder_kernel", 5 * MS, 20 * MS), ("add_kernel", 30 * MS, 36 * MS),
           ("ladder_kernel", 55 * MS, 85 * MS), ("ntt", 95 * MS, 99 * MS)]
    spans = [(trace.WINDOW, 0, 100 * MS), ("cells.prove", 0, 40 * MS),
             ("das.prove", 2 * MS, 38 * MS), ("das.fk20.msm", 4 * MS, 21 * MS),
             ("cells.prove", 50 * MS, 90 * MS), ("das.prove", 52 * MS, 88 * MS)]
    host = [("cudaStreamSynchronize", 3 * MS, 4 * MS),
            ("cudaStreamSynchronize", 10 * MS, 11 * MS),
            ("cudaStreamSynchronize", 45 * MS, 46 * MS)]
    return trace.Trace(device_ops=ops, spans=spans, host_ops=host)


def test_das_metrics_by_hand():
    reqs = [{"kind": "open", "blobs": 9}] * 2
    cfg = {"coefficients": 4096, "cell": 64}
    run = harness.Run(cell="c", config=cfg, mix={}, trace=_das_trace(), requests=reqs,
                      launches={"g1_ladder": 20, "g1_add": 160, "field_elementwise": 300},
                      device_name="NVIDIA H100 80GB HBM3")
    # das.prove 2-38: busy 5-20, 30-36 (21 of 36, idle 15); 52-88: busy 55-85 (idle 6)
    assert harness.metric_reader("das.idle_ms")(run) == pytest.approx(10.5)
    assert harness.metric_reader("das.syncs")(run) == pytest.approx(1.0)
    assert harness.metric_reader("kernels.launches_per_blob")(run) == pytest.approx(480 / 18)
    mod = harness.metric_module("das.fk20_roofline_pct")
    # per blob: 8192 products and 8064 additions, two FFTs of 448 butterflies, 321 twiddles
    assert mod.blob_products(4096, 64) == (8192 * (255 * 7 + 64 * 11) + 8064 * 16
                                           + 2 * (2 * 448 * 16 + 321 * (255 * 7 + 64 * 11)))
    least = mod.blob_products(4096, 64) * 300 / 16.75e12
    # busy inside cells.prove: 15 + 6 + 30 = 51 ms
    assert mod.read(run) == pytest.approx(100 * 18 * least / 0.051)
    run.device_name = "another card"
    assert mod.read(run) is None
    bare = harness.Run(cell="c", config=cfg, mix={}, trace=trace.Trace(
        device_ops=[("k", MS, 2 * MS)], spans=[(trace.WINDOW, 0, 10 * MS)]), requests=reqs)
    for name in ("das.idle_ms", "das.syncs"):
        assert harness.metric_reader(name)(bare) is None


def test_cells_kind_loads_no_jax():
    probe = ("import json, sys\nimport kzgbench.das, kzgbench.traffic.cells, "
             "kzgbench.reference.das\nprint(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "kzg_tpu", "kzg_tpu_torch"}
