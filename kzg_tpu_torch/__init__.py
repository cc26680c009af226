"""kzg_tpu_torch: the KZG polynomial commitment framework on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `kzg_tpu` (JAX + Pallas on a TPU), module for module. It imports
torch and never JAX, directly or through `kzg_tpu`: the host-only modules it
needs (constants, oracle, native engine binding, serialization) are copies.
Field elements are (W, *batch) int32 tensors of 32-bit Montgomery words
(fields/limb.py); every Pallas kernel of the JAX package (the single and
batched coefficient-form openings up to 2^24 coefficients, the
evaluation-form path with its Lagrange SRS, device setup, the matmul-DFT
NTT, the multiply probe) has its CUDA kernel in `csrc/`, built at first use
(kernels.py); the device pairing (`pairing/`) runs on those kernels.
Constructors place tensors on `config.device`, the card by default; a CPU
run asks for it (`configure(device="cpu")`).
"""

__version__ = "0.1.0"
