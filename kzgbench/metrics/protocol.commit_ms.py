"""protocol.commit_ms: mean milliseconds of the benchmark's span around
each `KZGProver.commit` in the window, closed by a synchronize."""


def read(run):
    spans = run.window_spans("open.commit")
    return 1e3 * sum(spans) / len(spans) if spans else None
