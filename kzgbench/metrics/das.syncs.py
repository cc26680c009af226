"""das.syncs: the host's waits for the device that start inside the
program's `das.prove` spans (`kzg_tpu_torch.trace`) in the window, over the
count of outermost such spans there (those no other such span contains): a
request's waits. A wait is a `cudaStreamSynchronize` or
`cudaDeviceSynchronize` call on the window's thread: torch makes one for
each `nonzero`, `.tolist()`, `bool()` or `.item()` of a device tensor and
each copy from pageable host memory, so the runtime counts what no
call-site counter would. None where the trace holds no such span."""

from kzgbench.trace import clip, merge

SPAN = "das.prove"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


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
    waits = sum(any(a <= s < b for a, b in inside)
                for name, s, _ in run.trace.host_ops if name in SYNCS)
    return waits / count
