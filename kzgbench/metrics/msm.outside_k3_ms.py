"""msm.outside_k3_ms: the mean commit span less the device time of K3
(`bucket_accumulate_kernel`) inside it, in milliseconds: the MSM's time
outside its bucket kernel (digits, sort, run splitting, host syncs, the
combine, the window join)."""

K3 = "bucket_accumulate_kernel"


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.spans_named("open.commit")
    if not spans:
        return None
    from kzgbench.trace import device_ns_in

    outside = sum(e - s for s, e in spans) - device_ns_in(run.trace, K3, spans)
    return outside / len(spans) / 1e6
