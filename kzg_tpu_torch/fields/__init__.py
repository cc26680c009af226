"""Field instances of the port."""

from ..constants import P, R
from .limb import LimbField

# Fr: the BLS12-381 scalar field (polynomial coefficients live here).
FR = LimbField(R, 8, name="Fr", kernel_id=0)

# Fp: the BLS12-381 base field (curve point coordinates live here).
FP = LimbField(P, 12, name="Fp", kernel_id=1)
