"""Run one cell of the port's benchmark and print its result line.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then ``checks``: each number the correctness check
compared, beside its limit); the compared numbers are also the last lines
of standard error.  Without a card, or with a module of JAX or of the JAX
package loaded, it exits non-zero and prints no result.

The program under test is the PyTorch port under ``src/``.  Its kernels
build into ``build/`` inside the checkout (so only a checkout's first run
compiles); any Triton or Inductor cache goes there too.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "chipbench" / sub)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench import core
    sys.exit(core.main())
