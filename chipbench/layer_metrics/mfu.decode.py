"""Share (%) of the bf16 peak that the decode rounds reached: the flops
the window's decoded tokens need (real rows only, routed experts only,
attention over each row's own context) over the rounds' device time (CUDA
events)."""
from chipbench.costs import PEAK_BF16_FLOPS


def read(ctx):
    d = ctx.get("decode")
    if not d or not d["ms"]:
        return None
    return 100.0 * ctx["decode_flops"] / (d["ms"] / 1e3) / PEAK_BF16_FLOPS
