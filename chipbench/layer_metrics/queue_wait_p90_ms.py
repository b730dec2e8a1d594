"""The 90th percentile of a request's queue wait (submit to first admit,
the program's own reading) over the requests first admitted in the traced
slice."""
from chipbench import program_spans


def read(ctx):
    return program_spans.mark_p90("queue_wait_ms", ctx)
