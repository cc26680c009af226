"""verify_p95_ms: the 95th percentile (nearest rank) of the latencies of
every verification in the window, in milliseconds."""

import math


def read(run):
    lat = sorted(r["latency_s"] for r in run.requests if r["kind"] == "verify")
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
