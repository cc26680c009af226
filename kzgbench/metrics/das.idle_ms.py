"""das.idle_ms: the window's device idle time inside the program's
`das.prove` spans (`kzg_tpu_torch.trace`, one a call of
`compute_cells_and_kzg_proofs`), in milliseconds, over the count of
outermost `das.prove` spans in the window (those no other such span
contains): a request's idle time. Idle is the window less the union of
device operations. None where the trace holds no such span, as in a program
without spans."""

from kzgbench.trace import clip, merge

SPAN = "das.prove"


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window()
    spans = [(s, e) for s, e in run.trace.spans_named(SPAN) if s < hi and e > lo]
    count = sum(not any(a <= s and e <= b and (a, b) != (s, e) for a, b in spans)
                for s, e in spans)
    if not count:
        return None
    inside = merge(clip(spans, lo, hi))
    busy = merge(clip([(s, e) for _, s, e in run.trace.device_ops], lo, hi))
    idle = sum(e - s for s, e in inside)
    for a, b in inside:
        idle -= sum(e - s for s, e in clip(busy, a, b))
    return idle / count / 1e6
