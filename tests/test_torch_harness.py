"""The port's entry points beside the library: `kzg_tpu_torch.smoke` (the
coeff_2e10 round trip), `bench.harness` (the reference's six criterion
groups) and `bench.scaling` (the sharded MSM's strong-scaling sweep), on
the CPU. The runs that take the plain twins through MSMs (the smoke, the
msm / commit / eval_form / verify groups, a gloo sweep) take more than 30 s
here and are `slow`; the rest run in the tier-1 suite. On the card the
smoke's phase 26 runs all of them."""

import contextlib
import io
import json

import pytest
import torch

from kzg_tpu_torch import bench, config, smoke
from kzg_tpu_torch.bench import harness, scaling

SLOW_GROUPS = ("msm", "commit", "eval_form", "verify")


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    """One intra-op thread: the twins' ops are tiny. The entry points set
    the device they are given and restore the configuration after."""
    old, threads = config.get_config(), torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


@pytest.mark.slow
def test_smoke_passes_on_the_cpu(capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert smoke.main([]) == 1
    assert config.get_config().device == "cuda"


@pytest.mark.parametrize("group", [
    pytest.param(g, marks=pytest.mark.slow) if g in SLOW_GROUPS else g for g in harness.GROUPS])
def test_harness_group_writes_its_keys(group, tmp_path):
    out = tmp_path / "h.json"
    assert harness.main(["--device", "cpu", "--group", group, "--sizes", "16",
                         "--json", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["device"] == "cpu"
    assert sorted(res["results"]) == sorted(harness.expected_keys(group, 16))
    assert all(v > 0 for v in res["results"].values())


def test_harness_writes_a_trace_per_group(tmp_path):
    assert harness.main(["--device", "cpu", "--group", "fft", "--sizes", "4",
                         "--profile-dir", str(tmp_path)]) == 0
    trace = json.loads((tmp_path / "fft" / "trace.json").read_text())
    assert trace["traceEvents"]


def _sweep(argv, entry=scaling.main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.slow
def test_scaling_sweep_on_gloo():
    rc, out = _sweep(["--device", "cpu", "--devices", "1,2", "--log-n", "8", "--timeout", "600"])
    assert rc == 0 and out["backend"] == "gloo" and out["skipped"] == []
    assert [r["devices"] for r in out["sweep"]] == [1, 2]
    assert out["sweep"][0]["efficiency_vs_1dev"] == 1.0


def test_scaling_skips_counts_without_cards():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc, out = _sweep(["--devices", "1,2"])
    assert rc == 0 and out["sweep"] == [] and out["value"] is None
    assert [s["devices"] for s in out["skipped"]] == [1, 2]
    assert all(s["reason"] == "only 0 cards" for s in out["skipped"])


def test_bench_exports_the_entry_points(tmp_path):
    out = tmp_path / "h.json"
    assert bench.harness_main(["--device", "cpu", "--group", "fft", "--sizes", "4",
                               "--json", str(out)]) == 0
    assert sorted(json.loads(out.read_text())["results"]) == sorted(
        harness.expected_keys("fft", 4))
    if not torch.cuda.is_available():
        rc, res = _sweep(["--devices", "1"], bench.scaling_main)
        assert rc == 0 and [s["devices"] for s in res["skipped"]] == [1]


def test_scaling_efficiency_is_against_the_first_count_run(monkeypatch):
    """With the first listed count skipped (too few cards), each efficiency
    is still against the count that ran first."""
    from kzg_tpu_torch.parallel import runtime

    def fake_launch(argv, world_size, timeout, env=None):
        with open(argv[argv.index("--out") + 1], "w") as f:
            json.dump({"seconds": 1.0 / world_size, "sum": [0]}, f)

    monkeypatch.setattr(runtime, "launch", fake_launch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    rc, out = _sweep(["--devices", "4,1,2"])
    assert rc == 0 and [s["devices"] for s in out["skipped"]] == [4]
    assert [r["efficiency_vs_1dev"] for r in out["sweep"]] == [1.0, 1.0]
