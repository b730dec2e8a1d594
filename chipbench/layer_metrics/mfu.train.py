"""Share (%) of the bf16 peak over the window: the model flops of every
step completed in the window (6 per matmul parameter per token, the
output projection included, plus attention forward and backward; no
recompute) over the window's seconds."""
from chipbench.costs import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.get("train_flops"):
        return None
    return 100.0 * ctx["train_flops"] / ctx["window_s"] / PEAK_BF16_FLOPS
