"""The metrics' arithmetic on synthetic runs and a synthetic trace, whose
answers are worked out by hand."""

import pytest
import torch

from kzgbench import harness, trace
from kzgbench.reference import fr
from kzgbench.reference.bls import R

MS = 1_000_000  # nanoseconds


def _read(name, run):
    return harness.metric_reader(name)(run)


def _trace():
    """A 100 ms window with two commit spans of 20 ms; K3 runs 12 ms in the
    first, 8 ms in the second, and 4 ms outside both; the pairing kernels
    run 6 + 3 ms; other kernels overlap some of them."""
    ops = [
        ("void bucket_accumulate_kernel<Fp>(unsigned int*)", 12 * MS, 24 * MS),
        ("void bucket_accumulate_kernel<Fp>(unsigned int*)", 52 * MS, 60 * MS),
        ("void bucket_accumulate_kernel<Fp>(unsigned int*)", 80 * MS, 84 * MS),
        ("horner_join_kernel", 22 * MS, 26 * MS),        # overlaps K3 by 2 ms
        ("miller_loop_kernel", 90 * MS, 96 * MS),
        ("final_exp_kernel", 96 * MS, 99 * MS),
        ("elementwise", 105 * MS, 110 * MS),             # outside the window
    ]
    spans = [(trace.WINDOW, 0, 100 * MS), ("open.commit", 10 * MS, 30 * MS),
             ("open.commit", 50 * MS, 70 * MS), ("open.witness", 30 * MS, 45 * MS)]
    host = [("aten::nonzero", 40 * MS, 49 * MS), ("aten::sort", 61 * MS, 75 * MS)]
    return trace.Trace(device_ops=ops, spans=spans, host_ops=host)


def test_busy_and_idle():
    t = _trace()
    # busy: 12-26 (14), 52-60 (8), 80-84 (4), 90-99 (9) = 35 ms of 100
    assert trace.busy_ns(t) == 35 * MS
    run = harness.Run(cell="c", config={}, mix={}, trace=t, requests=[{"kind": "open"}])
    assert _read("device.idle_pct.open", run) == pytest.approx(65.0)
    assert _read("device.idle_pct.verify", run) is None


def test_device_time_in_spans():
    t = _trace()
    spans = t.spans_named("open.commit")
    assert trace.device_ns_in(t, "bucket_accumulate", spans) == 20 * MS
    run = harness.Run(cell="c", config={}, mix={}, trace=t)
    # (20 - 12) and (20 - 8) ms outside K3: mean 10
    assert _read("msm.outside_k3_ms", run) == pytest.approx(10.0)


def test_pairing_and_launches_per_verify():
    t = _trace()
    run = harness.Run(cell="c", config={}, mix={}, trace=t,
                      requests=[{"kind": "verify", "latency_s": 0.01}] * 3,
                      launches={"miller_loop": 3, "final_exp": 3, "field_elementwise": 201})
    assert _read("pairing.device_ms", run) == pytest.approx(3.0)
    assert _read("kernels.launches_per_verify", run) == pytest.approx(69.0)
    no_pairing = harness.Run(cell="c", config={}, mix={}, trace=trace.Trace(
        device_ops=[("elementwise", MS, 2 * MS)], spans=[(trace.WINDOW, 0, 10 * MS)]),
        requests=[{"kind": "verify", "latency_s": 0.01}])
    assert _read("pairing.device_ms", no_pairing) is None


def test_top_ops_and_idle_gaps():
    t = _trace()
    top = dict(trace.top_device_ops(t))
    assert top["bucket_accumulate_kernel<Fp>"] == pytest.approx(0.024)
    assert "elementwise" not in top  # outside the window
    gaps = dict(trace.idle_gaps(t))
    # gaps: 0-12, 26-52, 60-80, 84-90, 99-100 ms; midpoints 6, 39, 70, 87, 99.5
    assert gaps["between spans"] == pytest.approx(0.012 + 0.006 + 0.001)
    assert gaps["open.witness"] == pytest.approx(0.026)
    assert gaps["open.commit/aten::sort"] == pytest.approx(0.020)
    assert sum(gaps.values()) == pytest.approx(0.065)


def test_kernel_names_keep_their_template_arguments():
    name = "void (anonymous namespace)::k<(anonymous namespace)::G1, 3>(unsigned int*, long long)"
    assert trace._short(name) == "(anonymous namespace)::k<(anonymous namespace)::G1, 3>"
    assert trace._short("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert trace._short("miller_loop_kernel") == "miller_loop_kernel"


def test_end_to_end_metrics():
    lat = [i / 1000 for i in range(1, 101)]  # 1 .. 100 ms
    run = harness.Run(cell="c", config={}, mix={}, setup_s=4.5, window_s=10.0,
                      requests=[{"kind": "verify", "latency_s": x} for x in lat])
    assert _read("setup_s", run) == 4.5
    assert _read("verifies_per_s", run) == pytest.approx(10.0)
    assert _read("verify_p95_ms", run) == pytest.approx(95.0)
    assert _read("open_s", run) is None
    jobs = harness.Run(cell="c", config={}, mix={}, window_s=10.0,
                       requests=[{"kind": "open"}] * 25,
                       spans=[("open.commit", 0.7, 0.9), ("window", 0.95, 10.95),
                              ("open.commit", 1.0, 1.2), ("open.commit", 2.0, 2.4),
                              ("open.witness", 3.0, 3.1), ("setup.srs", 0.1, 0.6)])
    assert _read("open_s", jobs) == pytest.approx(0.4)
    assert _read("protocol.commit_ms", jobs) == pytest.approx(300.0)
    assert _read("protocol.witness_ms", jobs) == pytest.approx(100.0)
    assert _read("setup.srs_s", jobs) == pytest.approx(0.5)
    assert _read("verify_p95_ms", jobs) is None


def test_setup_s_leaves_out_the_reference_in_set_up(bench):
    """The verify cell's proofs are the reference's work, made as a sender
    would: their span is reported apart and is not in setup_s."""
    import time

    from conftest import small_cell
    from kzgbench.reference.system import ReferenceSystem

    cell = small_cell(bench, "eip4844_blob.verify")
    t0 = time.perf_counter()
    out = harness.run_cell(cell, 2**31 + 11, 0.2, False, ReferenceSystem(torch.device("cpu")),
                           torch.device("cpu"), t0)
    stages = out["setup_stages_s"]
    assert out["correct"] and stages["reference.proofs"] > 0
    assert {"setup.srs", "setup.inputs", "setup.warmup"} <= set(stages)
    setup_s = out["metrics"]["setup_s"]["value"]
    assert 0 < setup_s <= sum(v for k, v in stages.items() if k.startswith("setup.")) + 0.05


def _words(values):
    mont = [v * (1 << 256) % R for v in values]
    return torch.tensor([[(v >> (32 * j)) & 0xFFFFFFFF for v in mont] for j in range(8)],
                        dtype=torch.int64).to(torch.int32)


def test_k3_work_count_by_hand():
    mod = harness.metric_module("kernels.k3_roofline_pct")
    # window 0 digits 1, 1, 2, 0; window 1 digits 0, 0, 0, 3; above: 0
    values = [1, 1, 2, 3 << 16]
    # window 0: 3 nonzero into 2 buckets -> 1 add; window 1: 1 into 1 -> 0
    assert mod.madds(_words(values)) == 1
    values = [5 + (7 << 16) + (9 << 240)] * 4
    # every window with a digit: 4 into one bucket -> 3 adds, three windows
    assert mod.madds(_words(values)) == 9
    peaks = {"int32_madd_per_s": 3300.0, "bytes_per_s": 1e30}
    assert mod.least_seconds(_words(values), peaks) == pytest.approx(9.0)


def test_k3_roofline_reads_the_commit_spans():
    t = _trace()
    values = [5 + (7 << 16)] * 4  # 6 additions a commit
    state = {"jobs": [{"poly": 0}, {"poly": 0}], "words": [_words(values)]}
    run = harness.Run(cell="c", config={}, mix={}, trace=t, state=state,
                      device_name="NVIDIA H100 80GB HBM3")
    least = 6 * 11 * 300 / 16.75e12
    bytes_s = (4 * 128 + 16 * 65535 * 144) / 3.35e12
    want = 100.0 * 2 * max(least, bytes_s) / 0.020
    assert _read("kernels.k3_roofline_pct", run) == pytest.approx(want)
    run.device_name = "another card"
    assert _read("kernels.k3_roofline_pct", run) is None


def test_limbs_round_trip():
    vals = [0, 1, R - 1, 12345678901234567890]
    limbs = fr.ints_to_limbs(vals, torch.device("cpu"))
    assert fr.limbs_to_ints(limbs) == vals
