"""Device milliseconds per training step of the operations that ran inside
the device-side extent of the trainer's `optimizer` span (the
accumulation, and on one step of each grad_accum_every the clipped AdamW
update), over the traced steps."""

NAME = "train.optimizer_ms"
UNIT = "ms"
LAYER = "trainer"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(run):
    if run.spans.get("driver") != "train" or run.trace is None:
        return None
    sec, spans = run.trace.seconds_in_span("optimizer")
    return 1e3 * sec / spans if spans else None
