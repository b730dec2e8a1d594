"""Mean device ms of one decode replay alone in the traced slice: the
program's CUDA events around each ``decode_step`` graph replay."""
from chipbench import program_spans


def read(ctx):
    return program_spans.replay_ms("decode_step", ctx)
