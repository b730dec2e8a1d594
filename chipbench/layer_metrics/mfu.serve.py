"""Share (%) of the bf16 peak over the whole window: the flops every
prompt and output token served in the window needs, over the window's
seconds."""
from chipbench.costs import PEAK_BF16_FLOPS


def read(ctx):
    total = ctx["prefill_flops"] + ctx["decode_flops"]
    if not total:
        return None
    return 100.0 * total / ctx["window_s"] / PEAK_BF16_FLOPS
