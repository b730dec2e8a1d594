"""Share (%) of its roofline that the tensor-core flash forward reached in
the traced slice of training: the sum of each call's bound,
max(bytes / HBM bandwidth, flops / bf16 peak) by ``costs.flash_fwd_cost``,
over the kernel's summed device time."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["flash_fwd"][0]:
        return None
    return 100.0 * t["flash_fwd_bound_s"] / (t["flash_fwd"][1] / 1e9)
