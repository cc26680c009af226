"""protocol.witness_ms: mean milliseconds of the benchmark's span around
each evaluation and `KZGProver.create_witness` in the window, closed by a
synchronize."""


def read(run):
    spans = run.window_spans("open.witness")
    return 1e3 * sum(spans) / len(spans) if spans else None
