"""Share of the traced stretch of open-loop load in which no operation
ran on the device while the dispatcher held a batch open for co-batching:
the program's `serve.collect` spans (utils/profiling's ring, on the
profiler's clock) less the device's busy intervals, over the stretch."""

from portbench import program_spans

NAME = "serve.collect_idle_share"
UNIT = "ratio"
LAYER = "serving"
SOURCE = "device_trace"
MOVES = "serve_latency_p90_s"


def read(run):
    if run.spans.get("driver") != "serve" or run.trace is None:
        return None
    stretch = program_spans.stretch(run.trace)
    spans = None if stretch is None else program_spans.ring_since(stretch[0])
    if spans is None:
        return None
    collect = [(s, e) for name, s, e, _, _ in spans if name == "serve.collect"]
    idle = program_spans.idle_ns(program_spans.clip(collect, *stretch), run.trace.device)
    return idle / (stretch[1] - stretch[0])
