"""The share of their roofline that the flash attention forward kernel (K1)
reach in the traced training steps: the least time of every call's work at
its shape (each causal group's CFG-doubled rows x heads, the level's
frames, the head width; causal pairs where the group is causal;
portbench/flops.py) over the device time of the kernels that did it."""

from portbench import flops

NAME = "attn_fwd_roofline.train"
UNIT = "%"
LAYER = "attention kernels"
SOURCE = "device_trace"
MOVES = "train_audio_s_per_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "train" or run.trace is None:
        return None
    sec, calls = run.trace.seconds_matching(flops.ATTN_KERNELS["attn_fwd"])
    work = [w for w in sp.get("traced_attention", []) if w[0] == "attn_fwd"]
    if not calls or sec <= 0 or calls != len(work):
        return None
    return 100.0 * sum(flops.bound_s(f, b) for _, f, b in work) / sec
