"""Device ms of one paged prefill replay: the CUDA-event time of every
``advance_prefill`` call in the window over the replays they made."""


def read(ctx):
    p = ctx.get("prefill")
    if not p or not p["replays"]:
        return None
    return p["ms"] / p["replays"]
