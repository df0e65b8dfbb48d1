"""Milliseconds per DDIM step in the service: `last_timings["sampler"]`
of the window's batches summed, over their steps (every clip length)."""

NAME = "sampler.ms_per_step.serve"
UNIT = "ms"
LAYER = "sampler and compiled sampling"
SOURCE = "program_span"
MOVES = "serve_latency_p90_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "serve" or not sp.get("batches"):
        return None
    return 1e3 * sum(b["timings"]["sampler"] for b in sp["batches"]) / (
        len(sp["batches"]) * sp["steps"])
