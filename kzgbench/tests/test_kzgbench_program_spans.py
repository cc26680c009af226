"""The four readers of the program's spans (`msm.idle_ms`, `msm.syncs`,
`verify.idle_ms`, `verify.syncs`) on synthetic traces whose answers are
worked out by hand: nested and sibling spans, an idle gap that straddles a
span's edge, a wait just outside a span, and a trace of a program without
spans, which reads None."""

import pytest

from kzgbench import harness, trace

MS = 1_000_000  # nanoseconds


def _read(name, t):
    return harness.metric_reader(name)(harness.Run(cell="c", config={}, mix={}, trace=t))


def _msm_trace():
    """A 100 ms window. Two commits hold one `msm` each: 10-40 and 60-80 ms.
    The first has two siblings inside (`msm.split` 12-20, `msm.accumulate`
    20-36); a second `msm` nested in it (14-18, a chunk) does not count
    twice. The device runs 5-15 (straddling the first span's start), 22-30
    and 34-45 (straddling its end), and 62-78. A third `msm` starts at 95
    and ends past the window, clipped to 95-100, with no device work."""
    ops = [("k_a", 5 * MS, 15 * MS), ("k_b", 22 * MS, 30 * MS), ("k_c", 34 * MS, 45 * MS),
           ("k_d", 62 * MS, 78 * MS), ("k_e", 110 * MS, 120 * MS)]
    spans = [(trace.WINDOW, 0, 100 * MS), ("open.commit", 8 * MS, 42 * MS),
             ("msm", 10 * MS, 40 * MS), ("msm.split", 12 * MS, 20 * MS),
             ("msm", 14 * MS, 18 * MS), ("msm.accumulate", 20 * MS, 36 * MS),
             ("open.commit", 58 * MS, 82 * MS), ("msm", 60 * MS, 80 * MS),
             ("msm", 95 * MS, 105 * MS)]
    host = [("cudaStreamSynchronize", 9 * MS, 10 * MS),       # just before the first msm
            ("cudaStreamSynchronize", 16 * MS, 17 * MS),      # inside both nested msm
            ("aten::nonzero", 19 * MS, 20 * MS),              # not a wait
            ("cudaStreamSynchronize", 31 * MS, 33 * MS),
            ("cudaDeviceSynchronize", 79 * MS, 81 * MS),      # starts inside, ends outside
            ("cudaStreamSynchronize", 80 * MS, 81 * MS),      # starts at the span's end
            ("cudaStreamSynchronize", 96 * MS, 97 * MS)]
    return trace.Trace(device_ops=ops, spans=spans, host_ops=host)


def test_msm_idle_ms():
    # inside the msm spans: 10-40 (busy 10-15, 22-30, 34-40: 19 of 30, idle 11),
    # 60-80 (busy 62-78, idle 4), 95-100 (idle 5): 20 ms over 3 outermost spans
    assert _read("msm.idle_ms", _msm_trace()) == pytest.approx(20 / 3)


def test_msm_syncs():
    # starting inside an msm span: 16, 31, 79 (device sync) and 96; not 9 (before),
    # not 80 (at the end), not the nonzero: 4 waits over 3 spans
    assert _read("msm.syncs", _msm_trace()) == pytest.approx(4 / 3)


def _verify_trace():
    """A 50 ms window with two verifications, each a benchmark span
    `verify` around the program's `kzg.verify_eval`, which holds the
    siblings `verify.xh` and `verify.to_affine` and, in the second,
    `pairing.read` with its wait."""
    ops = [("ladder", 2 * MS, 6 * MS), ("miller_loop_kernel", 8 * MS, 20 * MS),
           ("ladder", 26 * MS, 30 * MS), ("miller_loop_kernel", 33 * MS, 44 * MS)]
    spans = [(trace.WINDOW, 0, 50 * MS),
             ("verify", 0, 22 * MS), ("kzg.verify_eval", 1 * MS, 21 * MS),
             ("verify.xh", 1 * MS, 7 * MS), ("verify.to_affine", 7 * MS, 8 * MS),
             ("verify", 24 * MS, 48 * MS), ("kzg.verify_eval", 25 * MS, 47 * MS),
             ("verify.xh", 25 * MS, 31 * MS), ("verify.to_affine", 31 * MS, 33 * MS),
             ("pairing.read", 44 * MS, 47 * MS)]
    host = [("cudaStreamSynchronize", 3 * MS, 4 * MS),
            ("cudaStreamSynchronize", 21 * MS, 22 * MS),      # in `verify`, after verify_eval
            ("cudaStreamSynchronize", 27 * MS, 28 * MS),
            ("cudaStreamSynchronize", 45 * MS, 47 * MS)]
    return trace.Trace(device_ops=ops, spans=spans, host_ops=host)


def test_verify_idle_ms_and_syncs():
    t = _verify_trace()
    # 1-21: busy 2-6, 8-20 (16), idle 4; 25-47: busy 26-30, 33-44 (15), idle 7
    assert _read("verify.idle_ms", t) == pytest.approx(5.5)
    # waits at 3, 27 and 45; the one at 21 is outside kzg.verify_eval
    assert _read("verify.syncs", t) == pytest.approx(1.5)
    # no msm span in a verification cell
    assert _read("msm.idle_ms", t) is None and _read("msm.syncs", t) is None


@pytest.mark.parametrize("name", ["msm.idle_ms", "msm.syncs", "verify.idle_ms",
                                  "verify.syncs"])
def test_no_program_spans_reads_none(name):
    """The trace of a program without spans (the benchmark's own spans
    only) and an untraced run read None."""
    t = trace.Trace(device_ops=[("k", MS, 2 * MS)],
                    spans=[(trace.WINDOW, 0, 10 * MS), ("open.commit", 0, 5 * MS),
                           ("verify", 5 * MS, 9 * MS)],
                    host_ops=[("cudaStreamSynchronize", 3 * MS, 4 * MS)])
    assert _read(name, t) is None
    assert harness.metric_reader(name)(harness.Run(cell="c", config={}, mix={})) is None
