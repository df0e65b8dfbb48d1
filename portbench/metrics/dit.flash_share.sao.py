"""Share of the DiT's self-attention calls over the window that took the
flash route (K1 on the card): the program's counters SELF_ATTN_FLASH /
(SELF_ATTN_FLASH + SELF_ATTN_PLAIN) (models/dit.py, counted at every
graph replay)."""

NAME = "dit.flash_share.sao"
UNIT = "ratio"
LAYER = "attention kernels"
SOURCE = "program_counter"
MOVES = "gen_audio_s_per_s"


def read(run):
    sp = run.spans
    c = sp.get("counters") if sp.get("driver") == "generate_dit" else None
    if not c:
        return None
    calls = c["SELF_ATTN_FLASH"] + c["SELF_ATTN_PLAIN"]
    return c["SELF_ATTN_FLASH"] / calls if calls > 0 else None
