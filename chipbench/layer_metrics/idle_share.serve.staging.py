"""Share (%) of the traced slice in which the card was idle while the host
was in the round programs' host work around each replay
(``serve.prefill`` and its children, ``serve.decode.feed``,
``serve.decode.replay``): the idle gaps the program's span recorder read
from its CUDA events, by the innermost span open, over the slice's
seconds."""
from chipbench import program_spans


def read(ctx):
    return program_spans.idle_share("staging", ctx)
