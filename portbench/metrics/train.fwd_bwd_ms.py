"""Device milliseconds per training step of the loss's forward and
backward: the operations from the device-side start of the trainer's
`forward_backward` span to that of its `optimizer` span (one stream; the
backward runs on autograd's own thread, outside the span's own extent),
over the traced steps."""

NAME = "train.fwd_bwd_ms"
UNIT = "ms"
LAYER = "trainer"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(run):
    if run.spans.get("driver") != "train" or run.trace is None:
        return None
    sec, spans = run.trace.seconds_between("forward_backward", "optimizer")
    return 1e3 * sec / spans if spans else None
