"""Share of the traced batch in which no operation ran on the device, from
the profiler's trace."""

NAME = "idle_share.sao"
UNIT = "ratio"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "gen_audio_s_per_s"


def read(run):
    if run.spans.get("driver") != "generate_dit" or run.trace is None:
        return None
    return 1.0 - run.trace.busy_s() / run.trace.window_s
