"""kernels.launches_per_blob: the program's own launch counters
(`kzg_tpu_torch.kernels.REGISTRY`), summed over the window, over the blobs
the window's requests proved (each request's record carries its blob
count). A prover whose launches do not grow with the blobs of a call reads
its launches a call divided by the blobs a call."""


def read(run):
    blobs = sum(r.get("blobs", 0) for r in run.requests)
    if not blobs or not run.launches:
        return None
    return sum(run.launches.values()) / blobs
