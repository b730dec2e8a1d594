"""Mean device ms of one paged prefill replay alone in the traced slice:
the program's CUDA events around each ``prefill_paged`` graph replay."""
from chipbench import program_spans


def read(ctx):
    return program_spans.replay_ms("prefill_paged", ctx)
