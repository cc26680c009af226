"""Copy of `kzg_tpu/constants.py`. The `kzg_tpu` package imports JAX in
its `__init__`, so the port, which runs where JAX is absent, cannot import
even the JAX-free modules of that package.

BLS12-381 curve constants, shared by the oracle and the TPU compute path.

All derived quantities (roots of unity, Montgomery parameters) are computed
from first principles with Python ints at import time so there is no risk of
a mistyped magic constant; the primary constants (p, r, generators) are the
published BLS12-381 values and are validated by on-curve/subgroup checks in
the test suite.

Reference parity: the Rust reference uses blstrs (zkcrypto-compatible) whose
Fr exposes S = 32, multiplicative generator 7, and ROOT_OF_UNITY =
7^((r-1)/2^32) mod r (see reference src/ft.rs:55-89 for how omega is derived
from ROOT_OF_UNITY and the S = 32 two-adicity bound).
"""

# Base field prime (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Scalar field prime (255 bits) = order of G1/G2 subgroups.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative). |x| has low Hamming weight -> short Miller loop.
BLS_X = -0xD201000000010000

# Curve equations: E(Fp): y^2 = x^3 + 4;  E'(Fp2): y^2 = x^3 + 4(u+1).
B_G1 = 4
B_G2 = (4, 4)  # 4 + 4u as (c0, c1)

# --- Fr (scalar field) two-adic structure -------------------------------
FR_TWO_ADICITY = 32  # r - 1 = 2^32 * odd
assert (R - 1) % (1 << FR_TWO_ADICITY) == 0
assert ((R - 1) >> FR_TWO_ADICITY) % 2 == 1
FR_GENERATOR = 7  # smallest multiplicative generator of Fr*
# 2^32-th primitive root of unity (matches blstrs Scalar::ROOT_OF_UNITY).
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)

# --- Group generators (published BLS12-381 values) ----------------------
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# --- Limb layout for the TPU compute path --------------------------------
# 16-bit limbs stored in uint32 lanes: products fit in 32 bits, column sums
# of <= 24 partial products fit comfortably after a lo/hi split.
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
FR_LIMBS = 16   # 256 bits >= 255
FP_LIMBS = 24   # 384 bits >= 381


def to_limbs(x: int, n_limbs: int, limb_bits: int = LIMB_BITS):
    """Little-endian fixed-width limb decomposition of a nonnegative int."""
    mask = (1 << limb_bits) - 1
    return [(x >> (i * limb_bits)) & mask for i in range(n_limbs)]


def from_limbs(limbs, limb_bits: int = LIMB_BITS) -> int:
    acc = 0
    for i, limb in enumerate(limbs):
        acc |= int(limb) << (i * limb_bits)
    return acc
