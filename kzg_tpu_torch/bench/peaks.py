"""The field-multiply speed-of-light probe (port of `mul_peak`,
`bench.py:172-196` of the JAX package's bench).

Kernel K8 (`fields.cuda_field.mul_chain`) runs k dependent Montgomery
products an element in one launch. Timing k = 1 and k = 65 and taking the
difference cancels every fixed cost (launch, dispatch, the loads and the
store), which leaves the rate at which the card does a dependent multiply
with its operands in registers: the unit the kernel table's bounds should
be stated in. A single-multiply timing is launch-bound and understates it.
"""

from dataclasses import dataclass

import torch

from ..config import resolve_device
from ..fields import cuda_field

K_SHORT, K_LONG = 1, 65


@dataclass(frozen=True)
class MulPeak:
    """Rates in field multiplications a second; `launch_ms` is the k = 1
    launch, `long_ms` the k = 65 one (CUDA events, mean over `iters`)."""

    field: str
    lanes: int
    rate: float           # lanes * 65 / t65
    marginal_rate: float  # lanes * 64 / (t65 - t1)
    launch_ms: float
    long_ms: float
    iters: int


def random_elements(field, lanes: int, generator: torch.Generator) -> torch.Tensor:
    """(W, lanes) Montgomery words below the modulus, drawn on the
    generator's device: every word free but the top one, which stays below
    the modulus's top word (the values are not uniform over the field, which
    a timing does not need)."""
    dev = generator.device
    low = torch.randint(-(1 << 31), 1 << 31, (field.W - 1, lanes), generator=generator,
                        device=dev, dtype=torch.int64)
    top = torch.randint(0, field.modulus >> (32 * (field.W - 1)), (1, lanes),
                        generator=generator, device=dev, dtype=torch.int64)
    return torch.cat([low, top]).to(torch.int32)


HOLD_CYCLES = 20_000_000  # ~10 ms of the card's clock: longer than the host takes to enqueue


def _event_ms(fn, variants, iters: int) -> float:
    """Mean milliseconds a call of fn over the operand variants in turn,
    after one warm-up call, by CUDA events. A spin kernel holds the stream
    while the host enqueues the events and the calls, so the card runs them
    back to back and the events read device time even where one call is
    shorter than the host's time to launch it (a chain at one element)."""
    fn(variants[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for i in range(iters):
        fn(variants[i % len(variants)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def held_ms(fn, iters: int) -> float:
    """Device milliseconds a call of fn, by CUDA events around calls that
    the card runs back to back (`_event_ms` on one operand set)."""
    return _event_ms(lambda _: fn(), [None], iters)


def mul_peak(field, lanes: int, device=None, generator: torch.Generator | None = None,
             iters: int = 20, cooperative: bool = False) -> MulPeak:
    """Measure `field`'s multiply rate on the card with K8 at `lanes`
    elements (the bench uses 2^19). Operands come from `generator` (default:
    a fresh one on the device, seed 0). At `lanes=1` the marginal time of a
    product, 1 / marginal_rate, is its latency: that of the one-thread CIOS,
    or with `cooperative` that of the 16-lane product kernel K4 chains.
    Needs a CUDA device: a timing of the plain version on the CPU would not
    be a rate of the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"mul_peak times kernel K8 on a card; got device {dev}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    a = random_elements(field, lanes, generator)
    b = random_elements(field, lanes, generator)
    variants = [torch.roll(a, i, dims=-1) for i in range(4)]
    t1 = _event_ms(lambda v: cuda_field.mul_chain(field, K_SHORT, v, b, cooperative),
                   variants, iters)
    t2 = _event_ms(lambda v: cuda_field.mul_chain(field, K_LONG, v, b, cooperative),
                   variants, iters)
    return MulPeak(
        field=field.name, lanes=lanes,
        rate=lanes * K_LONG / (t2 * 1e-3),
        marginal_rate=lanes * (K_LONG - K_SHORT) / (max(t2 - t1, 1e-9) * 1e-3),
        launch_ms=t1, long_ms=t2, iters=iters,
    )
