"""The PeerDAS calls of the traffic kind "cells" (`traffic/cells.py`), for
each system the harness may hand it, chosen here so that `system.py`,
`reference/system.py` and `faults.py` keep to the calls of the other kinds:

  * the program (`system.Port`, name "kzg_tpu_torch"): the cell prover of
    `kzg_tpu_torch.kzg.das` over the program's SRS, imported when the
    calls are made (a program without it fails there, in set-up);
  * the reference in its place (`reference.system.ReferenceSystem`): the
    closed forms of `reference/das.py` from the SRS's secret, every proof's
    scalar cut to its low `scalar_bits` bits where the control asks;
  * a planted fault (`faults.Faulty`): the base system's calls with the
    fault planted in them, the call count including the warm-up: "stale"
    returns the first call's outputs from the second call on, "half"
    leaves out the proofs of half of the blobs, "altered" adds 1 to one
    cell value every fifth call, "lost" raises every fifth call.

An output is a dict: "cells", (8, B, cells, l) Montgomery words, and
"proofs", the system's own points, which `proof_bytes` reads as ZCash bytes
(blob by blob, cell by cell) and `proof_key` as a key of their exact
representation (a digest of the program's words; the reference's memo
entry): two outputs with one key have the same bytes.
"""

import hashlib

import torch

from .faults import Faulty, Lost
from .reference import das as ref
from .reference.bls import R, g1_compress
from .reference.system import ReferenceSystem


def calls_for(system):
    if isinstance(system, Faulty):
        return _Faulty(calls_for(system.base), system.fault)
    if isinstance(system, ReferenceSystem):
        return _Reference(system)
    if system.name == "kzg_tpu_torch":
        return _Port()
    raise TypeError(f"no PeerDAS calls for the system {system.name!r}")


class _Port:
    def prover(self, srs, cfg):
        from kzg_tpu_torch.kzg.das import DAS

        das = DAS(srs, cfg["coefficients"], cfg["cell"])
        das.fk20_table  # FK20's set-up, with the SRS, as a client's trusted-setup load
        return das

    def prove(self, das, blobs) -> dict:
        cells, proofs = das.compute_cells_and_kzg_proofs(blobs)
        return {"cells": cells, "proofs": proofs}

    def proof_key(self, out) -> bytes:
        words = torch.cat([t.reshape(-1) for t in out["proofs"]]).cpu().numpy().tobytes()
        return hashlib.sha256(words).digest()

    def proof_bytes(self, out) -> list:
        from kzg_tpu_torch.compat.serialize import g1_compress as compress
        from kzg_tpu_torch.curve import g1_from_device

        flat = tuple(t.reshape(t.shape[0], -1) for t in out["proofs"])
        return [compress(p) for p in g1_from_device(flat)]


class _Reference:
    def __init__(self, system):
        self.bits = system.scalar_bits
        self._memo = {}

    def prover(self, srs, cfg):
        return {"cells": ref.Cells(srs["s"], cfg["coefficients"], cfg["cell"]),
                "g": ref.FixedBase(), "cell": cfg["cell"]}

    def prove(self, state, blobs) -> dict:
        """The block's outputs, kept by the words' identity (the entry holds
        the words, so the identity is not reused while it lives)."""
        if id(blobs) not in self._memo:
            lanes, n = blobs.shape[1], blobs.shape[2]
            values = ref.values(blobs)
            ext, proofs = [], []
            for b in range(lanes):
                e, q = state["cells"].blob(values[b * n:(b + 1) * n])
                ext += e
                proofs += [state["g"].mul(self._narrow(k)) for k in q]
            cells = ref.mont_words(ext, blobs.device).reshape(8, lanes, -1, state["cell"])
            self._memo[id(blobs)] = (blobs, {"cells": cells, "proofs": proofs})
        return self._memo[id(blobs)][1]

    def _narrow(self, k: int) -> int:
        return k if self.bits is None else k & ((1 << self.bits) - 1)

    def proof_key(self, out) -> bytes:
        """The memo's list of points is one object a block for as long as
        the memo lives."""
        return id(out["proofs"]).to_bytes(8, "little")

    def proof_bytes(self, out) -> list:
        return [g1_compress(p) for p in out["proofs"]]


def add_one(cells, index: int):
    """A copy of the (8, ...) Montgomery words with value `index` (flat, C
    order) raised by 1 in the field."""
    out = cells.clone()
    flat = out.reshape(out.shape[0], -1)
    v = ref.values(flat[:, index:index + 1])[0]
    flat[:, index] = ref.mont_words([(v + 1) % R], out.device)[:, 0]
    return out


class _Faulty:
    def __init__(self, base, fault: str):
        self.base, self.fault = base, fault
        self.calls = 0
        self.first = None

    def prover(self, srs, cfg):
        return self.base.prover(srs, cfg)

    def prove(self, prover, blobs) -> dict:
        self.calls += 1
        if self.fault == "lost" and self.calls % 5 == 0:
            raise Lost("cell proofs lost")
        out = self.base.prove(prover, blobs)
        if self.fault == "stale":
            self.first = self.first or out
            return self.first
        if self.fault == "altered" and self.calls % 5 == 0:
            return {**out, "cells": add_one(out["cells"], 0)}
        if self.fault == "half":
            return {**out, "half": blobs.shape[1] // 2}
        return out

    def proof_key(self, out) -> bytes:
        return self.base.proof_key(out) + bytes([out.get("half", 255) % 256])

    def proof_bytes(self, out) -> list:
        got = self.base.proof_bytes(out)
        if "half" in out:
            per_blob = len(got) // out["cells"].shape[1]
            got = got[:out["half"] * per_blob]
        return got
