"""Share (%) of the traced slice in which the card was idle while the host
was in a sample call (``serve.sample``, ``serve.sample.first``), its
read-back included: the idle gaps the program's span recorder read from
its CUDA events, by the innermost span open, over the slice's seconds."""
from chipbench import program_spans


def read(ctx):
    return program_spans.idle_share("sampling", ctx)
