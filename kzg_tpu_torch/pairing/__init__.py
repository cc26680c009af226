"""The BLS12-381 pairing on the device (port of `kzg_tpu/pairing/`): the
optimal ate Miller loop and the final exponentiation as one kernel launch
each on a card (`csrc/pairing.cuh`, programs from `pairing/schedule.py`),
and their plain versions, the Fp2 / Fp6 / Fp12 tower as tensor code over
K1 and `field_pow`."""

from .tower import (
    f12_conj,
    f12_eq,
    f12_frobenius,
    f12_from_oracle,
    f12_inv,
    f12_is_one,
    f12_mul,
    f12_one,
    f12_pow_static,
    f12_sqr,
    f12_to_oracle,
)
from .pairing import (
    final_exp_device,
    final_exp_plain,
    final_exp_product,
    miller_loop_device,
    miller_loop_plain,
    pairing_check_device,
    pairing_device,
)

__all__ = [
    "f12_mul", "f12_sqr", "f12_inv", "f12_conj", "f12_frobenius",
    "f12_pow_static", "f12_one", "f12_is_one", "f12_eq",
    "f12_from_oracle", "f12_to_oracle",
    "miller_loop_device", "miller_loop_plain", "final_exp_device", "final_exp_plain",
    "final_exp_product", "pairing_device", "pairing_check_device",
]
