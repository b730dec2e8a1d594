"""Share (%) of the traced slice in which the card was idle while the host
was in the gateway's and the scheduler's own host work
(``serve.gateway_step`` and ``serve.step`` outside their children,
``serve.admit``, ``serve.decode.build``, ``serve.retire``): the idle
gaps the program's span recorder read from its CUDA events, by the
innermost span open, over the slice's seconds."""
from chipbench import program_spans


def read(ctx):
    return program_spans.idle_share("scheduler", ctx)
