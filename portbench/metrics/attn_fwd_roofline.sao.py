"""The flash forward kernel's (K1's) share of its roofline in the traced
batch: the least time of its calls' work at the DiT's self-attention shape
(the CFG-doubled rows x heads, 1025 tokens, head dim 64;
portbench/flops_dit.py) over the device time of the kernels that did it."""

from portbench import flops

NAME = "attn_fwd_roofline.sao"
UNIT = "%"
LAYER = "attention kernels"
SOURCE = "device_trace"
MOVES = "gen_audio_s_per_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "generate_dit" or run.trace is None:
        return None
    sec, calls = run.trace.seconds_matching(flops.ATTN_KERNELS["attn_fwd"])
    if calls == 0 or sec <= 0:
        return None
    work = flops.attn_fwd(*sp["k1_shape"])
    return 100.0 * calls * flops.bound_s(*work) / sec
