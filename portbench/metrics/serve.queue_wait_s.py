"""Seconds a request waits in the service's queue, from its submit to the
formation of its batch: the service's phase_totals["queue_wait"] over its
stats["batched_requests"] in the window."""

NAME = "serve.queue_wait_s"
UNIT = "s"
LAYER = "serving"
SOURCE = "program_span"
MOVES = "serve_latency_p90_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "serve":
        return None
    (s0, s1), (p0, p1) = sp["stats"], sp["phases"]
    if "queue_wait" not in p1 or "batched_requests" not in s1:
        return None
    requests = s1["batched_requests"] - s0.get("batched_requests", 0)
    if requests <= 0:
        return None
    return (p1["queue_wait"] - p0.get("queue_wait", 0.0)) / requests
