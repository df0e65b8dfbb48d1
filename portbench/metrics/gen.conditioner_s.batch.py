"""Seconds of the text conditioner (T5 and its projection) per batch,
from `Jen1.last_timings["conditioner"]` (synchronized) over the window's
batches."""

NAME = "gen.conditioner_s.batch"
UNIT = "s"
LAYER = "conditioning and codec"
SOURCE = "program_span"
MOVES = "gen_audio_s_per_s"


def read(run):
    batches = run.spans.get("batches") if run.spans.get("driver") == "generate" else None
    if not batches:
        return None
    return sum(t["conditioner"] for t in batches) / len(batches)
