"""The denoiser's share of the chip's bf16 peak over the window: the
UNet's FLOPs of every completed batch (portbench/flops.py; the CFG-doubled
batch, every step; T5 and the codec left out) over the window's seconds."""

from portbench import flops

NAME = "mfu.batch"
UNIT = "%"
LAYER = "denoiser"
SOURCE = "host_clock"
MOVES = "gen_audio_s_per_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "generate" or not sp.get("batches"):
        return None
    return flops.mfu_percent(len(sp["batches"]) * sp["unet_flops_per_batch"], sp["window_s"])
