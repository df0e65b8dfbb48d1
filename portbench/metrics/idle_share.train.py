"""Share of a training step of the measured window in which no operation
ran on the device: the device's busy seconds per traced step (the
profiler's trace) over the window's seconds per step (the host clock).
The profiler slows the eager step's host side, not its device work, so
the traced steps' own idle share would read higher than the window's."""

NAME = "idle_share.train"
UNIT = "ratio"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "train" or run.trace is None or not sp.get("steps"):
        return None
    busy = run.trace.busy_s() / sp["traced_steps"]
    return 1.0 - busy / (sp["window_s"] / sp["steps"])
