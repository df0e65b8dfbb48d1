"""Seconds of the Oobleck decode per batch (a clip at a time, host
transport, so it ends in a synchronize), from `Jen1.last_timings["decode"]`
over the window's batches."""

NAME = "gen.decode_s.sao"
UNIT = "s"
LAYER = "conditioning and codec"
SOURCE = "program_span"
MOVES = "gen_audio_s_per_s"


def read(run):
    batches = run.spans.get("batches") if run.spans.get("driver") == "generate_dit" else None
    if not batches:
        return None
    return sum(t["decode"] for t in batches) / len(batches)
