"""The denoiser's share of the chip's bf16 peak over the training window:
forward and backward (x3) UNet FLOPs of every step's CFG-doubled rows
(portbench/flops.py, causal groups' attention by their pairs; T5 left
out) over the window's seconds."""

from portbench import flops

NAME = "mfu.train"
UNIT = "%"
LAYER = "denoiser"
SOURCE = "host_clock"
MOVES = "train_audio_s_per_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "train" or not sp.get("steps"):
        return None
    return flops.mfu_percent(sp["flops"], sp["window_s"])
