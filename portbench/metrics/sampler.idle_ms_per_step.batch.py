"""Device-idle milliseconds per sampler step of the traced batch: the
program's `sampler.step` spans (utils/profiling's ring, on the profiler's
clock), each from its start to the next step's start and the last to the
end of its `gen.sampler` phase, less the device's busy intervals, over
the step count. The sum over the steps is the sampler phase's whole idle
from its first step on; the host runs ahead of the device, so a step's
own share is where the host stood, not what the device ran."""

from portbench import program_spans

NAME = "sampler.idle_ms_per_step.batch"
UNIT = "ms"
LAYER = "sampler and compiled sampling"
SOURCE = "device_trace"
MOVES = "gen_audio_s_per_s"


def read(run):
    if run.spans.get("driver") != "generate" or run.trace is None:
        return None
    stretch = program_spans.stretch(run.trace)
    spans = None if stretch is None else program_spans.ring_since(stretch[0])
    if spans is None:
        return None
    lo, hi = stretch
    phases = [s for s in spans if s[0] == "gen.sampler" and lo <= s[1] and s[2] <= hi]
    if not phases:
        return None
    _, start, end, thread, _ = phases[-1]
    steps = sorted(s[1] for s in spans
                   if s[0] == "sampler.step" and s[3] == thread and start <= s[1] <= end)
    if not steps:
        return None
    intervals = list(zip(steps, steps[1:] + [end]))
    return program_spans.idle_ns(intervals, run.trace.device) / 1e6 / len(steps)
