"""Requests over lanes run, over the window's batches: how full the
service's fixed max_batch batches were (the padding lanes run too)."""

NAME = "serve.batch_fill"
UNIT = "ratio"
LAYER = "serving"
SOURCE = "program_counter"
MOVES = "serve_latency_p90_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "serve" or not sp.get("batches"):
        return None
    (s0, s1) = sp["stats"]
    lanes = (s1["batches"] - s0["batches"]) * sp["max_batch"]
    if lanes <= 0:
        return None
    return (lanes - (s1["padded_lanes"] - s0["padded_lanes"])) / lanes
