"""Device ms of one decode round: the CUDA-event time of every
``decode_once`` call in the window over the replays they made."""


def read(ctx):
    d = ctx.get("decode")
    if not d or not d["replays"]:
        return None
    return d["ms"] / d["replays"]
