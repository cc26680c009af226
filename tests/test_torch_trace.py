"""The program's spans (`kzg_tpu_torch.trace`), on the CPU.

  * outside a `torch.profiler` session `span` is one shared no-op and
    nothing of the profiler is called;
  * inside a CPU session a commit on the K3 route (96 coefficients at
    c = 10, the size and window of the K3 twin's MSM in
    test_torch_bucket_split.py) opens the spans of its steps, nested as
    `trace.SPANS` says, and gives the same words as an untraced run;
  * every name the package opens is in `trace.SPANS`, and each name there
    is opened somewhere.

On the plain twins the MSM's bucket sum (K2) and window join (K4) take
~15 s a commit, so here they are stood in for by cheap functions of their
real inputs; the spans around them stay where they are. The witness's
division twin runs ~275,000 operations, each an event under the profiler
(~3 s), so the witness's tree and the verification's run on the card, in
test_torch_cuda.py.
"""

import pathlib
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kzg_tpu_torch import config, trace
from kzg_tpu_torch.curve import cuda_ops
from kzg_tpu_torch.kzg import setup
from kzg_tpu_torch.kzg.coeff_form import KZGProver
from kzg_tpu_torch.msm import pippenger
from kzg_tpu_torch.poly import Polynomial

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "kzg_tpu_torch"
N = 96
MSM_STEPS = ["msm.digits", "msm.split", "msm.accumulate", "msm.combine", "msm.bucket_sum",
             "msm.window_join"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old, threads = config.get_config(), torch.get_num_threads()
    config.configure(device="cpu", msm_window=10, small_msm_threshold=64)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    config.set_config(old)


def test_span_outside_a_session_is_a_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the profiler was called outside a session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    off = trace.span("msm")
    assert off is trace.span("kzg.commit")
    with off as got:
        assert got is None


def test_span_inside_a_session_is_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("msm.split"):
            torch.ones(4).sum()
    # `bench/paths.py` skips the entries named as a session's user annotation,
    # `chip_smoke.py` those named in SPANS
    assert [e.count for e in prof.key_averages() if e.key == "msm.split"] == [1]
    assert "msm.split" in {e.name() for e in prof.profiler.kineto_results.events()
                           if e.is_user_annotation()}


def _stand_ins(monkeypatch):
    """The bucket sum keeps bucket 1 of each window, the join window 0."""
    monkeypatch.setattr(pippenger, "weighted_bucket_sum",
                        lambda curve, acc: tuple(t[..., 1] for t in acc))
    monkeypatch.setattr(cuda_ops, "horner_join", lambda s_all, c: tuple(t[..., 0] for t in s_all))


def _spans(prof):
    """(name, parent) of every span, in the order they opened: the parent
    is the innermost span that holds it on the profiler's clock."""
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.device_type().name == "CPU"),
                 key=lambda t: (t[1], -t[2]))
    out = []
    for i, (name, s, e) in enumerate(evs):
        holders = [h for h in evs[:i] if h[1] <= s and e <= h[2]]
        out.append((name, min(holders, key=lambda h: h[2] - h[1])[0] if holders else None))
    return out


def test_commit_spans_on_the_k3_route(monkeypatch):
    _stand_ins(monkeypatch)
    taken = []
    bucket_runs = cuda_ops.bucket_runs
    monkeypatch.setattr(cuda_ops, "bucket_runs", lambda *a: taken.append(1) or bucket_runs(*a))
    prover = KZGProver(setup(0x5EED, N))
    poly = Polynomial.from_ints([(7 ** i) % 1_000_003 for i in range(N)])
    plain = prover.commit(poly)
    assert taken  # the K3 route
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = prover.commit(poly)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    assert _spans(prof) == [("kzg.commit", None), ("msm", "kzg.commit"),
                            *[(step, "msm") for step in MSM_STEPS]]


def test_spans_names_are_listed():
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        opened |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert opened == set(trace.SPANS)
    assert len(trace.SPANS) == len(set(trace.SPANS))
