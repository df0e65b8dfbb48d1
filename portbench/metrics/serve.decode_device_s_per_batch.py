"""Device seconds of the decode per served batch: the service's
phase_totals["decode_device"] (CUDA events around each batch's decode,
read by the completer after its fetch) over its batch count in the
window."""

NAME = "serve.decode_device_s_per_batch"
UNIT = "s"
LAYER = "conditioning and codec"
SOURCE = "program_span"
MOVES = "serve_latency_p90_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "serve":
        return None
    (s0, s1), (p0, p1) = sp["stats"], sp["phases"]
    batches = s1["batches"] - s0["batches"]
    if "decode_device" not in p1 or batches <= 0:
        return None
    return (p1["decode_device"] - p0.get("decode_device", 0.0)) / batches
