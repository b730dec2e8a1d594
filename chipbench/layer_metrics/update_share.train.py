"""Share (%) of the train step's device time in the optimizer's update:
device seconds of the ``train.update`` spans over those of
``train.grads``, ``train.reduce`` and ``train.update`` in the traced slice
(the program's CUDA events at each span's edges)."""
from chipbench import program_spans


def read(ctx):
    dev = program_spans.session(ctx).get("device_s", {})
    total = sum(dev.get(f"train.{p}", 0.0)
                for p in ("grads", "reduce", "update"))
    return 100.0 * dev.get("train.update", 0.0) / total if total else None
