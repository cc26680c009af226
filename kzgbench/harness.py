"""One run of one cell: set-up, the measured window, the metrics, the check.

Everything a cell needs is found by name: the cell's entry in
BENCHMARK.json and its file `workloads/<cell>.json`, the configuration
`configs/<config>.json`, the traffic mix `traffic/<traffic>.json`, whose
"kind" names the module `traffic/<kind>.py` that sets up, drives and checks
that kind of request, and one module `metrics/<metric>.py` a metric, whose
`read(run)` returns the number or None where it finds nothing to read.
A kind module has `setup(ctx) -> state`, `request(ctx, state, k) -> record`,
`collect(ctx, state)` (outputs read, the program's state dropped) and
`check(ctx, state) -> {name: (value, limit)}`. A kind's set-up names its
spans `setup.<stage>`; a span `reference.<stage>` is the reference making
inputs for the requests (as their sender would), and its seconds are left
out of `setup_s`.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

from . import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = "reference."  # spans of the reference's own work in set-up, not in setup_s


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    entry: dict
    end_to_end: list
    per_layer: list
    control: dict = None             # the control's options (`control.py`)
    here: str = HERE                 # the benchmark's folder the cell's files came from


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, here: str = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (already loaded) with its files.
    Raises KeyError for an unknown cell, ValueError where its file names
    another configuration or traffic than BENCHMARK.json does."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = load_json(here, "workloads", f"{name}.json")
    if (own["config"], own["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {own['config']} / {own['traffic']}, "
                         f"BENCHMARK.json {entry['config']} / {entry['traffic']}")
    config = load_json(here, "configs", f"{entry['config']}.json")
    mix = load_json(here, "traffic", f"{entry['traffic']}.json")
    return Cell(name=name, config=config, mix=mix, entry=entry,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                control=own.get("control"), here=here)


def kind_module(kind: str):
    return importlib.import_module(f"{__package__}.traffic.{kind}")


def metric_module(name: str, here: str = HERE):
    """The module metrics/<name>.py (names may hold dots, so by path)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: str = HERE):
    return metric_module(name, here).read


@dataclass
class Run:
    """What the metric readers read."""

    cell: str
    config: dict
    mix: dict
    state: dict = None
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: list = field(default_factory=list)
    spans: list = field(default_factory=list)   # (name, start_s, end_s) on the host clock
    launches: dict = None                        # the program's launch counts over the window
    trace: tracing.Trace = None
    device_name: str = ""

    def window_spans(self, name: str) -> list:
        """Seconds of each host-clock span `name` inside the window (the
        warm-up's spans, in set-up, left out)."""
        lo, hi = next(((s, e) for n, s, e in self.spans if n == tracing.WINDOW), (0.0, 0.0))
        return [e - s for n, s, e in self.spans if n == name and s >= lo and e <= hi]


class Context:
    """What a kind module sees: the seed, the cell's data, the system and
    the span recorder."""

    def __init__(self, seed, config, mix, system, device):
        self.seed, self.config, self.mix = seed, config, mix
        self.system, self.device = system, device
        self.spans = []
        self.profiling = False  # spans also become profiler ranges

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.profiling:
            from torch.profiler import record_function

            ctx = record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans.append((name, t0, time.perf_counter()))


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _latency_summary(requests) -> dict:
    """Nearest-rank quantiles of the requests' latencies (ms) and the mean
    of each half of the window (a drift inside the window shows there),
    for the record on standard error."""
    lat = [r["latency_s"] * 1e3 for r in requests if "latency_s" in r]
    if len(lat) < 4:
        return {}
    ranked, half = sorted(lat), len(lat) // 2
    out = {q: ranked[-(-len(lat) * int(q[1:]) // 100) - 1] for q in ("p50", "p90", "p95", "p99")}
    out["max"] = ranked[-1]
    out["mean_by_half"] = [sum(lat[:half]) / half, sum(lat[half:]) / (len(lat) - half)]
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, system, device,
             t_start: float) -> dict:
    """Set up, measure for `seconds`, read the metrics and check. Returns
    the result object without its "device" key's card facts (the caller
    adds them) and with "checks" last."""
    import torch

    kind = kind_module(cell.mix["kind"])
    ctx = Context(seed, cell.config, cell.mix, system, device)
    state = kind.setup(ctx)
    system.sync()
    run = Run(cell=cell.name, config=cell.config, mix=cell.mix, state=state)
    run.setup_s = time.perf_counter() - t_start - sum(
        e - s for n, s, e in ctx.spans if n.startswith(REFERENCE))
    prof = _profiler(device) if trace else None
    ctx.profiling = trace
    system.reset_launches()
    failed = attempted = 0
    with (prof if prof is not None else contextlib.nullcontext()):
        t0 = time.perf_counter()
        with ctx.span(tracing.WINDOW):
            while time.perf_counter() - t0 < seconds:
                attempted += 1
                try:
                    run.requests.append(kind.request(ctx, state, attempted - 1))
                except Exception as exc:  # noqa: BLE001 - a request that raises never answers
                    failed += 1
                    print(f"request {attempted - 1} failed: {exc!r}", file=sys.stderr,
                          flush=True)
            system.sync()
        run.window_s = time.perf_counter() - t0
    run.launches = system.launches()
    run.spans = ctx.spans
    ctx.profiling = False
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out = {"correct": False, "attempted": attempted, "failed": failed}
    if prof is not None:
        run.trace = tracing.from_profiler(prof)
        del prof
    run.device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    kind.collect(ctx, state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"], cell.here)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = {"memory_peak_bytes": peak}
    if run.trace is not None:
        out["device"]["busy_s"] = tracing.busy_ns(run.trace) / 1e9
        out["device"]["window_s"] = run.trace.window_s()
        out["breakdown"] = {"device_ops": tracing.top_device_ops(run.trace),
                            "idle_gaps": tracing.idle_gaps(run.trace)}
    checks = kind.check(ctx, state)
    checks["failed_requests"] = (failed, 0)
    out["correct"] = attempted > 0 and all(v <= lim for v, lim in checks.values())
    stages = out["setup_stages_s"] = {}
    for n, s, e in run.spans:
        if n.startswith(("setup.", REFERENCE)):
            stages[n] = stages.get(n, 0.0) + e - s
    out["latency_ms"] = _latency_summary(run.requests)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out
