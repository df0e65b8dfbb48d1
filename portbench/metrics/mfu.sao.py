"""The DiT's share of the chip's bf16 peak over the window: its FLOPs of
every completed batch (portbench/flops_dit.py; the CFG-doubled rows, every
step; T5 and the decoder left out) over the window's seconds."""

from portbench import flops

NAME = "mfu.sao"
UNIT = "%"
LAYER = "denoiser"
SOURCE = "host_clock"
MOVES = "gen_audio_s_per_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "generate_dit" or not sp.get("batches"):
        return None
    return flops.mfu_percent(len(sp["batches"]) * sp["dit_flops_per_batch"], sp["window_s"])
