"""The DiT's matrix products' share of the bf16 peak in the traced
batch's sampler: the FLOPs the library's GEMM kernels run per step (every
linear layer and the cross-attention products; portbench/flops_dit.py)
times the steps, over the device time of the kernels named as GEMMs
(`flops_dit.GEMM_KERNELS`) that ran inside the host extent of the
`gen.sampler` phase (which opens on an idle device and ends in a
synchronize, so it holds the sampler's kernels and no others)."""

from portbench import flops, flops_dit

NAME = "dit.gemm_roofline.sao"
UNIT = "%"
LAYER = "denoiser"
SOURCE = "device_trace"
MOVES = "gen_audio_s_per_s"


def read(run):
    sp, tr = run.spans, run.trace
    if sp.get("driver") != "generate_dit" or tr is None:
        return None
    ranges = sorted((s, e) for s, e, name in tr.host if name == "gen.sampler")
    sec = 0
    for s, e in ranges:
        for ds, de, name in tr.device:
            if s <= ds and de <= e and any(k in name for k in flops_dit.GEMM_KERNELS):
                sec += de - ds
    if sec <= 0:
        return None
    work = sp["steps"] * sp["dit_gemm_flops_per_step"]
    return 100.0 * work / (sec / 1e9) / flops.PEAK_FLOPS["bfloat16"]
