"""The readings a cell's correctness limits are set from, on the card.

    python3 chipbench/tools/readings.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 1 2 3] [--seconds 51] [--trace] \
        [--port-override moe_capacity_factor=16]

For each seed it runs the cell as the benchmark does (in one process, one
seed after the other) and prints one JSON line on standard output: the
program's compared numbers, and for the seeds in ``--control-seeds`` the
same numbers read off the control and the planted faults, each on the
same inputs:

* serving: the control is the reference computed with float8 products
  (``reference.model``'s ``precision="fp8"``); at each position of the
  same prompts and served tokens it reads the f32 reference's gap of the
  token the control puts first;
* training: the control is the fp8 reference stepped on the same
  batches, its numbers taken against the f32 reference's as the
  program's are; the fault "half of the batch left out, the mean taken
  over the rest" is the f32 reference stepped on each batch's first half.
  The fault "a step that returns its state unchanged" reads 1 on
  ``change_gap`` by its measure and needs no run.

``--trace`` runs the seeds traced (their per-layer metrics);
``--port-override key=value`` runs the port with one of its settings
changed (a comparison beside the cell, never a reading of it).
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--port-override", action="append", default=[])
    args = ap.parse_args()
    port_overrides = {k: json.loads(v) for k, v in
                      (o.split("=", 1) for o in args.port_override)}

    def edit(cell):
        port = dict(cell.config["port"])
        port["overrides"] = dict(port.get("overrides", {}), **port_overrides)
        cell.config = dict(cell.config, port=port)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from chipbench import core
    from chipbench.reference import train as rtrain

    bench = core.benchmark(ROOT)
    _, spec, _ = core.resolve(ROOT, bench, args.workload)
    mod = core.load_module(ROOT / "chipbench" / "traffic"
                           / f"{spec['kind']}.py", spec["kind"])
    extra = {}
    control = {"on": False}

    if spec["kind"] == "serve_closed_loop":
        plain = mod.reference_logits

        def reference_logits(params, config, seqs, dev, precision="f32"):
            out = plain(params, config, seqs, dev, precision)
            if control["on"]:
                ctl = plain(params, config, seqs, dev, "fp8")
                got = mod.served_numbers(
                    out, [c.argmax(dim=-1) for c in ctl])
                extra.update({f"control_{k}": v for k, v in got.items()})
            return out
        mod.reference_logits = reference_logits
    else:
        plain = rtrain.readings

        def readings(params0, cfg, batches, opt, **kw):
            r = plain(params0, cfg, batches, opt, **kw)
            if control["on"]:
                for name, k in (("control", {"precision": "fp8"}),
                                ("half_batch", {"half_batch": True})):
                    c = plain(params0, cfg, batches, opt, **dict(kw, **k))
                    extra.update({f"{name}_{n}": v for n, v in
                                  rtrain.compare(c, r).items()})
            return r
        rtrain.readings = readings

    for seed in args.seeds:
        extra.clear()
        control["on"] = seed in args.control_seeds
        res = core.run_cell(ROOT, args.workload, seed, args.seconds,
                            args.trace, overrides=edit)
        line = {"workload": args.workload, "seed": seed,
                "port_overrides": port_overrides, "trace": args.trace,
                "correct": res["correct"],
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                "extra": dict(extra),
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "device": res["device"], "notes": res["notes"]}
        print(json.dumps(line), flush=True)
        # one process runs every seed: hand the cached blocks back, so the
        # next seed's peak is a fresh process's
        del res
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
