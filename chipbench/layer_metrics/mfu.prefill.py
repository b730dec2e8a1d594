"""Share (%) of the bf16 peak that the prefill replays reached: the flops
the window's real prompt tokens need (routed experts only, the output
projection at each prompt's last token) over those replays' device time
(CUDA events)."""
from chipbench.costs import PEAK_BF16_FLOPS


def read(ctx):
    p = ctx.get("prefill")
    if not p or not p["ms"] or not ctx.get("prefill_tokens"):
        return None
    return 100.0 * ctx["prefill_flops"] / (p["ms"] / 1e3) / PEAK_BF16_FLOPS
