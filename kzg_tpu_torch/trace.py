"""Named ranges of the program's steps, on the profiler's clock.

`span(name)` is a context manager. Inside a `torch.profiler` session it
opens `torch.profiler.record_function(name)`; outside one it returns one
shared no-op context. The gate is the profiler's own flag, read at each
call (0.3 us a span on an H100 host), so a program nobody profiles calls
nothing of the profiler (a range costs ~13 us a call, with a session or
without). Any session sees the spans with no switch to turn on. The ranges
sit on the clock of the device activity in the session's trace, so each
stretch of device idle time can be put down to the innermost span open on
the host at that moment.

Names are `<layer>.<step>`. `SPANS` lists every name the program opens,
each beside what reads it: a metric of the benchmark (`kzgbench/metrics/`)
or its breakdown of idle time by innermost span. Readers that sum device
time by name skip these ranges (`chip_smoke.py`).
"""

import contextlib

import torch
from torch.autograd import profiler as _profiler

SPANS = (
    "kzg.commit",           # breakdown: `KZGProver.commit`
    "kzg.witness",          # breakdown: `KZGProver.create_witness`, streamed or not
    "kzg.verify_eval",      # verify.idle_ms, verify.syncs: `KZGVerifier.verify_eval`
    "poly.eval",            # breakdown: `Polynomial.eval` and its read of y
    "poly.divide",          # breakdown: `Polynomial.div_by_linear` (`fr_horner`)
    "msm",                  # msm.idle_ms, msm.syncs: one public `msm` call
    "msm.digits",           # breakdown: digits, stable sort, run bounds, point rows
    "msm.split",            # breakdown: `split_runs`, its `.tolist()` and two `nonzero`
    "msm.accumulate",       # breakdown: K3, or the K7 bucket loop
    "msm.combine",          # breakdown: `combine_runs`, two `nonzero` a level
    "msm.bucket_sum",       # breakdown: `weighted_bucket_sum` on K2
    "msm.window_join",      # breakdown: K4
    "verify.xh",            # breakdown: x h on the G2 digit ladder, its digit upload
    "verify.yg",            # breakdown: y g on the G1 digit ladder, its digit upload
    "verify.to_affine",     # breakdown: both affine conversions and their concatenations
    "pairing.miller_loop",  # breakdown: the `miller_loop` kernel's wrapper and launch
    "pairing.final_exp",    # breakdown: the `final_exp` kernel's wrapper and launch
    "pairing.read",         # breakdown: `f12_is_one` and the verdict's read
    "das.prove",            # das.idle_ms, das.syncs: `DAS.compute_cells_and_kzg_proofs`
    "das.cells",            # breakdown: the blobs' iNTT and the odd coset's NTT (`kzg/das.py`)
    "das.fk20.columns",     # breakdown: FK20's scalar NTTs of the blobs' columns
    "das.fk20.msm",         # breakdown: FK20's MSMs on the fixed table (`fk20_comb`)
    "das.fk20.g1_fft",      # breakdown: FK20's inverse and forward group NTTs
    "das.verify",           # breakdown: `DAS.verify_cell_kzg_proof_batch`
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range `name` while a session records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF

