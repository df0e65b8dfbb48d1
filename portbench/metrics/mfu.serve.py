"""The denoiser's share of the chip's bf16 peak while the service samples:
the UNet FLOPs of the window's batches (portbench/flops.py, padding lanes
and CFG rows included; T5 and the codec left out) over their summed
sampler-phase seconds (the fixed rate sets the window's work)."""

from portbench import flops

NAME = "mfu.serve"
UNIT = "%"
LAYER = "denoiser"
SOURCE = "program_span"
MOVES = "serve_latency_p90_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "serve" or not sp.get("batches"):
        return None
    sec = sum(b["timings"]["sampler"] for b in sp["batches"])
    return flops.mfu_percent(sum(b["flops"] for b in sp["batches"]), sec)
