"""das.fk20_roofline_pct: FK20's share of its roofline in the window: the
least time the card could take for the group work of the blobs the window's
requests proved, over the device's busy time inside the benchmark's own
request spans (`cells.prove`, one a request, closed by a synchronize).

The work is counted here, from the cell's sizes (n = "coefficients", l =
"cell"), and does not follow the implementation. A blob's FK20 is 2n
variable-base products of 255-bit scalars and their sums into 2n / l MSMs
of l terms (2n - 2n / l additions), then two group FFTs of 2m = 2n / l
points: m log2(2m) butterflies each, two additions a butterfly and one
variable-base product a butterfly whose twiddle is not 1 (all but 2m - 1).
A variable-base product is 255 doublings and 64 mixed additions (a 4-bit
window; the table of 15 multiples not counted, as a fixed base's is made
once). Products of Fp: a doubling 7 (dbl-2009-l, 2M + 5S), a mixed addition
11 (madd-2007-bl, 7M + 4S), an addition 16 (add-2007-bl, 11M + 5S); a
product 300 32-bit multiply-adds (a 12-word schoolbook product and its
Montgomery reduction). The bytes are each lane's point (96) and scalar (32)
read once and each proof (144) written once. The rates are the data
sheet's (`peaks.json`); a card not in that table gives no reading.
"""

import json
import os

from kzgbench.trace import clip, merge

SPAN = "cells.prove"
DBL, MADD, ADD = 7, 11, 16
PRODUCT = 255 * DBL + 64 * MADD
MADDS_PER_PRODUCT = 300
LANE_BYTES, PROOF_BYTES = 96 + 32, 144


def blob_products(n: int, l: int) -> int:
    """Products of Fp in one blob's FK20 group work."""
    size = 2 * n // l
    butterflies = size // 2 * (size.bit_length() - 1)
    fft = 2 * butterflies * ADD + (butterflies - (size - 1)) * PRODUCT
    return 2 * n * PRODUCT + (2 * n - size) * ADD + 2 * fft


def least_seconds(n: int, l: int, peaks) -> float:
    ops = blob_products(n, l) * MADDS_PER_PRODUCT / peaks["int32_madd_per_s"]
    moved = 2 * n * LANE_BYTES + 2 * n // l * PROOF_BYTES
    return max(ops, moved / peaks["bytes_per_s"])


def read(run):
    if run.trace is None:
        return None
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "peaks.json")) as f:
        peaks = json.load(f).get(run.device_name)
    spans = run.trace.spans_named(SPAN)
    blobs = sum(r.get("blobs", 0) for r in run.requests)
    if peaks is None or not spans or not blobs:
        return None
    lo, hi = run.trace.window()
    busy = merge(clip([(s, e) for _, s, e in run.trace.device_ops], lo, hi))
    ns = sum(e - s for a, b in spans for s, e in clip(busy, a, b))
    if not ns:
        return None
    least = least_seconds(run.config["coefficients"], run.config["cell"], peaks)
    return 100.0 * blobs * least / (ns / 1e9)
