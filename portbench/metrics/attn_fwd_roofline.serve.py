"""The flash forward kernel's (K1's) share of its roofline in the traced
load: the least time of its calls' work at the serving shape (the
CFG-doubled max_batch rows x heads, the level's frames, the head width;
portbench/flops.py) over the device time of the kernels that did it. Only
30 s requests reach the kernel; none read, no value."""

from portbench import flops
from portbench.drivers.generate import latent_frames

NAME = "attn_fwd_roofline.serve"
UNIT = "%"
LAYER = "attention kernels"
SOURCE = "device_trace"
MOVES = "serve_latency_p90_s"


def read(run):
    sp = run.spans
    if sp.get("driver") != "serve" or run.trace is None:
        return None
    sec, calls = run.trace.seconds_matching(flops.ATTN_KERNELS["attn_fwd"])
    mc = sp["cfg"]["model_config"]
    shapes = flops.flash_calls(mc, latent_frames(30 * 48_000))
    if calls == 0 or sec <= 0 or len(shapes) != 1:
        return None
    level, n = shapes[0]
    d = mc["channels"] * mc["multipliers"][level + 1] // mc["attention_heads"]
    work = flops.attn_fwd(2 * sp["max_batch"] * mc["attention_heads"], n, d)
    return 100.0 * calls * flops.bound_s(*work) / sec
