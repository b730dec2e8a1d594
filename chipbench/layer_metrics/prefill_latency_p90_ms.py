"""The 90th percentile of a request's prefill latency (first admit to
first token, the program's own reading) over the requests whose first
token came in the traced slice."""
from chipbench import program_spans


def read(ctx):
    return program_spans.mark_p90("prefill_latency_ms", ctx)
