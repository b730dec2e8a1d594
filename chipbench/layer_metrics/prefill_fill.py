"""Share (%) of the prefill positions the engine executed in the window
that were real prompt tokens: its ``prefill_tokens`` counter over its
``prefill_tokens_executed`` (padding rows and tokens of the (batch, chunk)
tile included)."""


def read(ctx):
    if not ctx.get("prefill_executed"):
        return None
    return 100.0 * ctx["prefill_tokens"] / ctx["prefill_executed"]
