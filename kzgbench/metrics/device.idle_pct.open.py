"""device.idle_pct.open: the share of the traced window in which no
operation ran on the device, in the opening cells."""

from kzgbench.trace import busy_ns


def read(run):
    if run.trace is None or not any(r["kind"] == "open" for r in run.requests):
        return None
    return 100.0 * (1.0 - busy_ns(run.trace) / 1e9 / run.trace.window_s())
