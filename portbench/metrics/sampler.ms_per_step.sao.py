"""Milliseconds per sampler step of the DiT: `Jen1.last_timings["sampler"]`
summed over the window's batches, over their steps."""

NAME = "sampler.ms_per_step.sao"
UNIT = "ms"
LAYER = "sampler and compiled sampling"
SOURCE = "program_span"
MOVES = "gen_audio_s_per_s"


def read(run):
    batches = run.spans.get("batches") if run.spans.get("driver") == "generate_dit" else None
    if not batches:
        return None
    return 1e3 * sum(t["sampler"] for t in batches) / (len(batches) * run.spans["steps"])
