"""Share of the traced unit of work (one batch) in which no operation ran
on the device, from the profiler's trace."""

NAME = "idle_share.batch"
UNIT = "ratio"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "gen_audio_s_per_s"


def read(run):
    if run.spans.get("driver") != "generate" or run.trace is None:
        return None
    return 1.0 - run.trace.busy_s() / run.trace.window_s
