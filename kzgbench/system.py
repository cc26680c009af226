"""The system under test: `kzg_tpu_torch` on one card, behind the few calls
the traffic kinds make. The harness takes from the program only this: its
provers and verifier, its SRS, its launch counters and the ZCash bytes of
the points it returns. Everything is imported when the object is made,
never when this module is imported.

The reference system (`reference/system.py`) has the same methods, so the
control and the planted faults run through the same harness.
"""

import os


class Port:
    name = "kzg_tpu_torch"

    def __init__(self, device, root: str):
        import torch

        from kzg_tpu_torch import kernels
        from kzg_tpu_torch.config import configure

        configure(device=str(device), srs_cache_dir=os.path.join(root, ".srs_cache"),
                  pairing_engine="device")
        self.torch = torch
        self.device = torch.device(device)
        if self.device.type == "cuda":  # the build (first run in a checkout) counts as set-up
            kernels.build()
            kernels.library()
        self.kernels = kernels

    # ---- set-up and inputs ----------------------------------------------------------

    def setup_srs(self, secret: int, g1_powers: int, g2_powers: int):
        from kzg_tpu_torch.kzg.srs import setup_device

        return setup_device(secret, g1_powers, g2_count=g2_powers, device=self.device)

    def polynomial(self, words):
        from kzg_tpu_torch.poly import Polynomial

        return Polynomial(words)

    def g1_inputs(self, affine_points) -> list:
        """Device points (the program's Jacobian batch-() triples) of affine
        integer pairs."""
        from kzg_tpu_torch.curve import g1_to_device
        from kzg_tpu_torch.oracle.field import Fp

        pts = g1_to_device([(Fp(x), Fp(y)) for x, y in affine_points], self.device)
        return [tuple(t[:, i].contiguous() for t in pts) for i in range(len(affine_points))]

    # ---- the timed calls ----------------------------------------------------------------

    def commit(self, srs, poly):
        from kzg_tpu_torch.kzg.coeff_form import KZGProver

        return KZGProver(srs).commit(poly)

    def evaluate(self, poly, x: int) -> int:
        return poly.eval(x)

    def witness(self, srs, poly, x: int, y: int):
        from kzg_tpu_torch.kzg.coeff_form import KZGProver

        return KZGProver(srs).create_witness(poly, (x, y), check=False)

    def verifier(self, srs):
        from kzg_tpu_torch.kzg.coeff_form import KZGVerifier

        return KZGVerifier(srs, engine="device")

    def verify(self, verifier, z: int, y: int, commitment, proof) -> bool:
        return bool(verifier.verify_eval((z, y), commitment, proof))

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    # ---- what the reference reads ---------------------------------------------------

    def g1_bytes(self, point) -> bytes:
        from kzg_tpu_torch.kzg.coeff_form import g1_compressed

        return g1_compressed(point)

    def srs_g1_bytes(self, srs, indices) -> list:
        from kzg_tpu_torch.compat.serialize import g1_compress
        from kzg_tpu_torch.curve import g1_from_device

        idx = self.torch.tensor(indices, device=self.device)
        return [g1_compress(p) for p in g1_from_device(tuple(t[..., idx] for t in srs.gs))]

    def srs_g2_bytes(self, srs, indices) -> list:
        from kzg_tpu_torch.compat.serialize import g2_compress
        from kzg_tpu_torch.curve import g2_from_device

        idx = self.torch.tensor(indices, device=self.device)
        return [g2_compress(p) for p in g2_from_device(tuple(t[..., idx] for t in srs.hs))]

    # ---- counters -------------------------------------------------------------------------

    def reset_launches(self):
        self.kernels.reset_launches()

    def launches(self) -> dict:
        return self.kernels.launch_counts()
