"""The harness: find a cell by its name, run its traffic kind, print one
result.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``chipbench/workloads/<cell>.json``: the cell's configuration name, its
  traffic ``kind``, the kind's parameters (traffic, engine or step
  settings) and the limits of its correctness check;
* the configuration's ``file`` (``chipbench/configs/<config>.json``): the
  published keys, and under ``port`` the port's architecture id and the
  settings the run gives it;
* ``chipbench/traffic/<kind>.py``: one generator and runner for every
  mix of its kind, with ``run(cell) -> dict``;
* ``chipbench/layer_metrics/<metric>.py``: ``read(ctx)``, the metric from
  what a traced run recorded, or None where it found nothing to read.

A cell, a configuration, a traffic kind or a per-layer metric is added by
adding files and ``BENCHMARK.json`` entries; no file here changes.

The run refuses to run without the cards its cell asks for (no CPU
fallback), and refuses to print a result when a module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package) was
loaded into the process.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot give a result (no card, a missing file, JAX
    loaded): exit non-zero and print no result line."""


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]            # the BENCHMARK.json workload entry
    spec: Dict[str, Any]             # chipbench/workloads/<name>.json
    config: Dict[str, Any]           # the configuration file
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    port_cfg: Any = None
    notes: List[str] = field(default_factory=list)

    def note(self, line: str) -> None:
        """A line for standard error (counts, sizes, what was checked)."""
        self.notes.append(line)


def _load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (its name may hold
    dots)."""
    if not path.is_file():
        raise Refused(f"no file {path}")
    mod_name = "chipbench_" + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path) -> Dict[str, Any]:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise Refused(f"no {path}")
    return _load_json(path)


def resolve(root: Path, bench: Dict[str, Any], name: str):
    """The workload entry, the cell's spec file and its configuration
    file."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    spec = _load_json(root / "chipbench" / "workloads" / f"{name}.json")
    if spec["config"] != entry["config"]:
        raise Refused(f"{name}: the workload file names config "
                      f"{spec['config']!r}, BENCHMARK.json {entry['config']!r}")
    config = _load_json(root / configs[entry["config"]]["file"])
    return entry, spec, config


def cell_metrics(bench: Dict[str, Any], name: str, trace: bool):
    """The metrics this cell reports: with ``trace`` its per-layer ones,
    else its end-to-end ones (a metric with a ``workloads`` key only in
    the cells it lists; a per-layer metric without one in every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def port_config(config: Dict[str, Any]):
    """The port's ModelConfig the file states: its architecture id (the
    smoke config where ``smoke`` is set, for tests) with ``overrides``,
    checked against the file's published sizes."""
    from repro_torch.configs import get_config, get_smoke_config
    port = config["port"]
    base = (get_smoke_config if port.get("smoke") else get_config)(
        port["arch"])
    cfg = base.with_(**port.get("overrides", {}))
    want = {"num_layers": "num_hidden_layers", "d_model": "hidden_size",
            "num_heads": "num_attention_heads",
            "num_kv_heads": "num_key_value_heads", "vocab_size": "vocab_size",
            "num_experts": "num_experts",
            "num_experts_per_tok": "num_experts_per_tok"}
    for ours, theirs in want.items():
        if theirs in config and getattr(cfg, ours) != config[theirs]:
            raise Refused(f"the port's {ours} is {getattr(cfg, ours)}, the "
                          f"configuration file's {theirs} {config[theirs]}")
    ff = config.get("moe_intermediate_size") or config.get(
        "intermediate_size")
    if ff is not None and cfg.d_ff != ff:
        raise Refused(f"the port's d_ff is {cfg.d_ff}, the file's {ff}")
    if cfg.resolved_head_dim != (config.get("head_dim") or
                                 config["hidden_size"]
                                 // config["num_attention_heads"]):
        raise Refused("the port's head dim differs from the file's")
    return cfg


def process_start() -> float:
    """The epoch time this process started (Linux ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden(modules) -> List[str]:
    """The top-level names in ``modules`` (dotted module names) that the
    benchmark must not load, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def forbidden_loaded() -> List[str]:
    return forbidden(list(sys.modules))


def require_cards(chips: int) -> str:
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards; "
                      f"{torch.cuda.device_count()} present")
    return torch.cuda.get_device_name(0)


def read_layer_metrics(root: Path, metrics, ctx: Dict[str, Any]
                       ) -> Dict[str, Any]:
    """Each per-layer metric from its reader; one that finds nothing to
    read is left out."""
    out = {}
    for m in metrics:
        reader = load_module(root / "chipbench" / "layer_metrics"
                             / f"{m['name']}.py", m["name"])
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda",
             overrides: Optional[Callable[[Cell], None]] = None
             ) -> Dict[str, Any]:
    """Run one cell and return its result object (without printing).
    ``device`` and ``overrides`` (a hook that edits the cell before its
    traffic kind runs) are for the CPU tests, which skip the look for a
    card."""
    t_start = process_start()
    bench = benchmark(root)
    entry, spec, config = resolve(root, bench, name)
    cell = Cell(name, entry, spec, config, int(seed), float(seconds),
                bool(trace), device)
    if overrides is not None:
        overrides(cell)
    kind = None
    if device == "cuda":
        kind = require_cards(entry["chips"])
    cell.port_cfg = port_config(cell.config)
    kind_mod = load_module(root / "chipbench" / "traffic"
                           / f"{cell.spec['kind']}.py", cell.spec["kind"])
    out = kind_mod.run(cell)
    metrics_wanted = cell_metrics(bench, name, trace)
    if trace:
        metrics = read_layer_metrics(root, metrics_wanted, out["layer_ctx"])
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_end"] - t_start)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in metrics_wanted}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": kind or device, "count": entry["chips"],
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if trace:
        device_info["busy_s"] = out["layer_ctx"]["trace"]["busy_s"]
        device_info["window_s"] = out["layer_ctx"]["trace"]["window_s"]
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device_info}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    result["notes"] = cell.notes
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = PKG.parent
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace))
        bad = forbidden_loaded()
        if bad:
            raise Refused(f"modules loaded that the benchmark must not "
                          f"load: {', '.join(bad)}")
    except Refused as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 2
    notes = result.pop("notes")
    for line in notes:
        print(line, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
