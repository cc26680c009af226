"""kernels.launches_per_verify: the program's own launch counters
(`kzg_tpu_torch.kernels.REGISTRY`), summed over the window, a
verification."""


def read(run):
    done = sum(r["kind"] == "verify" for r in run.requests)
    if not done or not run.launches:
        return None
    return sum(run.launches.values()) / done
