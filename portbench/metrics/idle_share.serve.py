"""Share of the traced stretch of open-loop load in which no operation
ran on the device, from the profiler's trace."""

NAME = "idle_share.serve"
UNIT = "ratio"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "serve_latency_p90_s"


def read(run):
    if run.spans.get("driver") != "serve" or run.trace is None:
        return None
    return 1.0 - run.trace.busy_s() / run.trace.window_s
