"""Measurement helpers of the port: the field-multiply probe
(`peaks.mul_peak`), the criterion-style harness of the reference's bench
groups (`harness`: `python -m kzg_tpu_torch.bench.harness`) and the
multi-device MSM scaling sweep (`scaling`: `python -m
kzg_tpu_torch.bench.scaling`), as in `kzg_tpu/bench/`, plus the kernel
benches of the port's redesigns (`horner`, `ladder`, `madd_multi`, `ntt`,
`pairing`, `pointwise`, `paths`, `runs_sweep`). The two entry points import their
module when called, so `python -m` runs either module once."""

from .peaks import MulPeak, mul_peak


def harness_main(argv=None) -> int:
    from .harness import main

    return main(argv)


def scaling_main(argv=None) -> int:
    from .scaling import main

    return main(argv)


__all__ = ["MulPeak", "harness_main", "mul_peak", "scaling_main"]
