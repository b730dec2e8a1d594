"""Share (%) of its roofline that the paged decode kernel reached in the
traced slice: the sum of each call's bound, max(bytes / HBM bandwidth,
flops / bf16 peak) by ``costs.decode_cost`` at the rows' own lengths,
over the summed device time of its split kernel and the combine kernel
launched after it."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["paged_decode"][0]:
        return None
    ns = t["paged_decode"][1] + t["paged_decode_combine"][1]
    return 100.0 * t["paged_decode_bound_s"] / (ns / 1e9)
