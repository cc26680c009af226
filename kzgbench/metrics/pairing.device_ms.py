"""pairing.device_ms: device milliseconds of the two pairing kernels
(`miller_loop_kernel`, `final_exp_kernel`) a verification, over the traced
window."""

from kzgbench.trace import device_ns_in

KERNELS = ("miller_loop_kernel", "final_exp_kernel")


def read(run):
    done = sum(r["kind"] == "verify" for r in run.requests)
    if run.trace is None or not done:
        return None
    window = [run.trace.window()]
    ns = sum(device_ns_in(run.trace, k, window) for k in KERNELS)
    return ns / done / 1e6 if ns else None
