"""Seconds a completer spends per batch fetching its audio to the host,
from the service's phase_totals["fetch"] over its batch count in the
window. Under device transport this holds the decode's device time."""

NAME = "serve.fetch_s_per_batch"
UNIT = "s"
LAYER = "serving"
SOURCE = "program_span"
MOVES = "serve_latency_p90_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "serve":
        return None
    (s0, s1), (p0, p1) = sp["stats"], sp["phases"]
    batches = s1["batches"] - s0["batches"]
    if batches <= 0:
        return None
    return (p1.get("fetch", 0.0) - p0.get("fetch", 0.0)) / batches
