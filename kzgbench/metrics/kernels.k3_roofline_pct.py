"""kernels.k3_roofline_pct: K3's share of its roofline in the commits of
the window: the least time the card could take for the bucket
accumulation the commits' scalars need, over K3's device time inside the
commit spans.

The work is counted here, from the cell's own scalars, and does not follow
the implementation: at a window of C = 16 bits, each window w of each
scalar a_i gives the digit d = (a_i >> 16 w) mod 2^16, and every nonzero
digit but the first into its bucket costs one mixed addition (bucket +
affine point): sum over windows of (nonzero digits - buckets used). A
mixed addition is 11 Fp products (7 multiplications and 4 squarings of
the madd-2007-bl formula), a product 300 32-bit multiply-adds (a 12-word
schoolbook product and its Montgomery reduction). The bytes are the
inputs read once (each point 96 bytes, each scalar 32) and the buckets
written once (144 bytes each). The rates are the data sheet's
(`peaks.json`); a card not in that table gives no reading. A later change
to a cheaper addition formula comes with a benchmark change of this count.
"""

import json
import os

import torch

from kzgbench.reference import fr
from kzgbench.trace import device_ns_in

K3 = "bucket_accumulate_kernel"
C = 16
PRODUCTS_PER_MADD = 11
MADDS_PER_PRODUCT = 300
POINT_BYTES, SCALAR_BYTES, BUCKET_BYTES = 96, 32, 144


def madds(words) -> int:
    """Mixed additions the bucket accumulation of one MSM at window C needs
    for the scalars given as Montgomery words (8, n)."""
    windows = -(-255 // C)
    nonzero = [0] * windows
    used = [torch.zeros(1 << C, dtype=torch.bool, device=words.device) for _ in range(windows)]
    for lo in range(0, words.shape[-1], 1 << 22):
        limbs = fr.from_mont(fr.limbs_of_words(words[:, lo:lo + (1 << 22)]))
        for w in range(windows):
            d = limbs[:, w]
            nonzero[w] += int((d != 0).sum())
            used[w] |= torch.bincount(d, minlength=1 << C) > 0
    return sum(nz - int(u[1:].sum()) for nz, u in zip(nonzero, used))


def least_seconds(words, peaks) -> float:
    n = words.shape[-1]
    ops = madds(words) * PRODUCTS_PER_MADD * MADDS_PER_PRODUCT / peaks["int32_madd_per_s"]
    buckets = -(-255 // C) * ((1 << C) - 1)
    moved = n * (POINT_BYTES + SCALAR_BYTES) + buckets * BUCKET_BYTES
    return max(ops, moved / peaks["bytes_per_s"])


def read(run):
    if run.trace is None:
        return None
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "peaks.json")) as f:
        peaks = json.load(f).get(run.device_name)
    spans = run.trace.spans_named("open.commit")
    jobs = run.state.get("jobs", []) if run.state else []
    if peaks is None or not spans or not jobs:
        return None
    k3_ns = device_ns_in(run.trace, K3, spans)
    if not k3_ns:
        return None
    per_poly = {}
    least = 0.0
    for j in jobs:
        if j["poly"] not in per_poly:
            per_poly[j["poly"]] = least_seconds(run.state["words"][j["poly"]], peaks)
        least += per_poly[j["poly"]]
    return 100.0 * least / (k3_ns / 1e9)
