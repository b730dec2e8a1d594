"""The dry-run as meta-device accounting (counterpart of
``repro.launch.dryrun``).

For an (architecture x input shape) pair this builds the step of the
shape's kind (``distributed.stepfn.make_step_for_shape``: train, prefill
or serve) for one rank of the production layout (``launch.mesh.
production_mesh``: (16, 16) over ``(data, model)``, or (2, 16, 16) over
``(pod, data, model)``) and runs it once on ``meta`` tensors over
``hvd.abstract_groups``: no device, no process group, no memory.  Rank 0
stands for every rank: under ``fit_spec`` every rank's shards have the
same shapes.  Where the reference lowers and compiles the program with
XLA and reads its analyses, this counts what the port's eager step does:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the aten
  ops, plus each kernel's own count (its ``meta`` route adds its
  ``cost`` to ``kernels._build.meta_cost``).
* ``bytes_accessed``: by definition here, the sum over every aten op that
  is not a view of the bytes of its tensor inputs and outputs (a 0-d
  tensor is a scalar and counts nothing), with the indexing ops counted
  by what they touch (a gather or index reads and
  writes its output's bytes and its indices; an index_put writes its
  values' bytes twice, read and write, and reads its indices), plus the
  kernels' own counts.  It is not XLA's figure: there is no fusion, so an
  eager chain of elementwise ops counts every intermediate.
* ``peak_memory_per_device``: a ``TorchDispatchMode`` adds each new
  storage's bytes to the live bytes when an op makes it and takes them
  off through a ``weakref.finalize`` on the storage; the arguments are
  live from the start; ``peak_at`` names where the peak was reached
  (this package's innermost three frames).  (Under a dispatch mode
  PyTorch's composite backward formulas write a fresh zeros tensor out
  of place, which the step without the mode writes in place: such an
  op's output is counted in the place of those zeros.)
  ``argument_size`` is the bytes of the params,
  optimizer state and batch handed to the step (this rank's shards,
  ``sharding.local_bytes`` of their specs); ``output_size`` the bytes of
  the outputs that alias no argument (the serve step's cache and the train
  step's params and AdamW state are written in place); ``temp_size`` the
  peak less the arguments.  ``fits``: the peak within the card's memory
  (``launch.mesh.H100_SXM_HBM_BYTES``).
* ``collective_bytes``: each collective's output bytes
  (``hvd.Group.output_bytes``' measure) by the reference's five kinds;
  ``collective_bytes_by_scope`` splits them by whether a group's ranks
  span two pods (``rank // 256``).

``trace_s`` (the time of the meta run) stands where the reference has
``compile_s``.  ``--unrolled`` is recorded and changes no count: the
port's layers are a Python loop, counted at full depth.

Usage (no device is needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
      [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "collective_permute": "collective-permute"}
POD_SIZE = 256

_aten = torch.ops.aten
# indexing ops counted by what they touch, not by their whole operands
_GATHERS = {_aten.index.Tensor, _aten.gather.default,
            _aten.index_select.default}
_PUTS = {_aten.index_put_.default, _aten.index_put.default,
         _aten._index_put_impl_.default}
# Under a dispatch mode PyTorch's composite backward formulas (gather's,
# index's) write their fresh zeros out of place (``scatter_add``,
# ``index_put``): the step without the mode writes them in place, so such
# an op's output is counted in the place of the zeros it was handed
_ZEROS = {_aten.new_zeros.default, _aten.zeros.default,
          _aten.zeros_like.default}
_OUT_OF_PLACE = {_aten.scatter_add.default, _aten.scatter.src,
                 _aten.index_put.default, _aten.index_add.default}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_bytes(t: torch.Tensor) -> int:
    """An operand's bytes for ``bytes_accessed``: a 0-d tensor is a scalar
    and counts nothing."""
    return _nbytes(t) if t.dim() else 0


def _site() -> str:
    """The innermost three frames of this package on the stack, innermost
    first (``file:line``): where an allocation was made."""
    frames = [f for f in traceback.extract_stack()[:-2]
              if "repro_torch" in f.filename and not
              f.filename.endswith("dryrun.py")]
    return " < ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                      for f in frames[-3:][::-1])


class Accounting(TorchDispatchMode):
    """Live storage bytes and their peak, where the peak was reached
    (``peak_at``, ``_site``), and the bytes every aten op touches (the
    module's definitions), while active."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak = 0
        self.peak_at = ""
        self.bytes_accessed = 0
        self._zeros = None       # the storage the last op made, if zeros

    def track(self, tree) -> None:
        """Count every tensor of ``tree``'s storage as live (once)."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key)
        if self.live_bytes > self.peak:
            self.peak = self.live_bytes
            self.peak_at = _site()

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        zeros, self._zeros = self._zeros, None
        if (func in _OUT_OF_PLACE and zeros is not None
                and args[0].untyped_storage()._cdata == zeros):
            self.live_bytes -= self.live.get(zeros, 0)
            self.live[zeros] = 0
        if not func.is_view:
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            if func in _GATHERS:
                idx = [t for t in ins[1:] if not t.is_floating_point()]
                n = 2 * sum(map(_op_bytes, outs)) + sum(map(_op_bytes, idx))
            elif func in _PUTS:
                n = 2 * _op_bytes(ins[-1]) + sum(map(_op_bytes, ins[1:-1]))
            else:
                n = sum(map(_op_bytes, ins)) + sum(map(_op_bytes, outs))
            self.bytes_accessed += n
        self.track(out)
        if func in _ZEROS:
            self._zeros = out.untyped_storage()._cdata
        return out


def _collectives(groups):
    """(bytes by the reference's kinds, bytes by scope) of every group's
    collectives, each counted by its output (``Group.output_bytes``)."""
    by_kind = {v: 0 for v in KINDS.values()}
    scope = {"intra_pod": 0, "inter_pod": 0}
    for g in groups._groups.values():
        span = len({r // POD_SIZE for r in g.ranks}) > 1
        for kind, out in g.output_bytes_by_kind().items():
            by_kind[KINDS[kind]] += out
            scope["inter_pod" if span else "intra_pod"] += out
    return by_kind, scope


def count_step(cfg, shape, strategy: str, mesh_shape: Dict[str, int],
               rank: int = 0, **train_kw) -> Dict:
    """Run the step of ``(cfg, shape)`` once on ``meta`` over rank
    ``rank``'s abstract groups of ``mesh_shape`` and return its counts
    (``train_kw``: a train step's ``loss_variant``, ``seq_chunk``,
    ``microbatches``, as the reference's hill-climb passes ``step_kw`` to
    ``make_train_step``; ``cfg.remat_policy`` is the config's):
    flops, bytes_accessed, collective_bytes (and by scope), the memory
    figures, trace_s, and ``groups_counts`` (``{axes: (calls, bytes)}``
    of what this rank handed each group's collectives)."""
    from repro_torch.core import hvd
    from repro_torch.distributed import stepfn
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import H100_SXM_HBM_BYTES

    groups = hvd.abstract_groups(dict(mesh_shape), rank)
    t0 = time.perf_counter()
    step, structs = stepfn.make_step_for_shape(cfg, groups, strategy, shape,
                                               device="meta", **train_kw)
    args = ((structs["params"], structs["opt_state"], structs["batch"])
            if shape.kind == "train" else (structs["params"],
                                           structs["batch"]))
    arg_keys = {t.untyped_storage()._cdata for t in _tensors(args)}
    argument_size = sum(map(_nbytes, _tensors(args)))
    _build.meta_cost.reset()
    groups.reset_counts()
    acct = Accounting()
    with FlopCounterMode(display=False) as fc, acct:
        acct.track(args)
        out = step(*args)
        outs = _tensors(out)
        output_size = sum(_nbytes(t) for t in outs
                          if t.untyped_storage()._cdata not in arg_keys)
    del out, outs
    coll, scope = _collectives(groups)
    peak = acct.peak
    return {
        "flops": float(fc.get_total_flops() + _build.meta_cost.flops),
        "bytes_accessed": float(acct.bytes_accessed + _build.meta_cost.bytes),
        "kernel_flops": _build.meta_cost.flops,
        "kernel_bytes": _build.meta_cost.bytes,
        "kernels": {k: list(v) for k, v in
                    _build.meta_cost.by_kernel.items()},
        "collective_bytes": coll,
        "collective_bytes_total": int(sum(coll.values())),
        "collective_bytes_by_scope": scope,
        "peak_memory_per_device": int(peak),
        "peak_at": acct.peak_at,
        "argument_size": int(argument_size),
        "output_size": int(output_size),
        "temp_size": int(peak - argument_size),
        "fits": bool(peak <= H100_SXM_HBM_BYTES),
        "trace_s": time.perf_counter() - t0,
        "groups_counts": {"/".join(k): list(v)
                          for k, v in groups.counts().items()},
    }


def dryrun_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
                strategy: Optional[str] = None, unrolled: bool = False,
                verbose: bool = True, cfg=None) -> Dict:
    """The record of one (arch x shape) pair on the production layout
    (the module's docstring).  ``cfg``: a config to use in place of the
    arch's (a cut depth)."""
    from repro_torch.configs import default_strategy, get_config
    from repro_torch.configs.base import SHAPES, shape_skips
    from repro_torch.launch.mesh import production_mesh

    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    skip = shape_skips(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": skip, "multi_pod": multi_pod}
    strategy = strategy or default_strategy(cfg)
    mesh = production_mesh(multi_pod=multi_pod)
    # under dp every rank is a data rank (the port's dp step reduces over
    # the data axis): the layout is (chips, 1)
    layout = ({"data": mesh.size, "model": 1} if strategy == "dp"
              else mesh.shape)
    counts = count_step(cfg, shape, strategy, layout)
    rec = {"arch": arch, "shape": shape_name, "status": "ok",
           "strategy": strategy, "multi_pod": multi_pod, "chips": mesh.size,
           "unrolled": unrolled}
    rec.update({k: v for k, v in counts.items() if k != "groups_counts"})
    if verbose:
        print(f"[{arch} x {shape_name} | {'2x16x16' if multi_pod else '16x16'}"
              f" | {strategy}] trace {rec['trace_s']:.2f}s  flops/dev "
              f"{rec['flops']:.3e}  bytes/dev {rec['bytes_accessed']:.3e}  "
              f"coll/dev {rec['collective_bytes_total']:.3e}  peak-mem/dev "
              f"{rec['peak_memory_per_device'] / 2**30:.2f} GiB  args "
              f"{rec['argument_size'] / 2**30:.2f} GiB  fits {rec['fits']}",
              flush=True)
    return rec


def _group_counts(cfg):
    """(G, cfg at 1 group, cfg at 2 groups): the reference's layer-group
    counts (a hybrid group is ``hybrid_attn_every`` mamba layers and the
    shared block, an encdec group one encoder and one decoder layer, a
    dense group one ``layer_pattern``)."""
    from repro_torch.models.transformer import layer_pattern
    if cfg.family == "hybrid":
        E, L = cfg.hybrid_attn_every, cfg.num_layers
        G, R = L // E, L % E
        return G, cfg.with_(num_layers=E + R), cfg.with_(num_layers=2 * E + R)
    if cfg.family == "encdec":
        assert cfg.encoder_layers == cfg.num_layers
        return cfg.num_layers, cfg.with_(num_layers=1, encoder_layers=1), \
            cfg.with_(num_layers=2, encoder_layers=2)
    pat = len(layer_pattern(cfg))
    return (cfg.num_layers // pat, cfg.with_(num_layers=pat),
            cfg.with_(num_layers=2 * pat))


def roofline_pair(arch: str, shape_name: str, *,
                  strategy: Optional[str] = None, multi_pod: bool = False,
                  verbose: bool = True, cfg=None) -> Dict:
    """Per-device roofline terms of (arch x shape), counted at full depth
    directly (the port has no scan body counted once, so nothing is
    extrapolated).  ``groups``: the reference's layer-group count
    (``_group_counts``); the counts are affine in it."""
    from repro_torch.configs import get_config
    cfg = cfg or get_config(arch)
    rec = dryrun_pair(arch, shape_name, multi_pod=multi_pod,
                      strategy=strategy, verbose=False, cfg=cfg)
    if rec["status"] != "ok":
        return rec
    out = {k: rec[k] for k in ("arch", "shape", "status", "strategy",
                               "multi_pod", "chips", "trace_s", "flops",
                               "bytes_accessed", "collective_bytes",
                               "collective_bytes_total")}
    out["groups"] = _group_counts(cfg)[0]
    if verbose:
        print(f"[roofline {arch} x {shape_name} | {out['strategy']}] "
              f"G={out['groups']} flops/dev {out['flops']:.3e}  bytes/dev "
              f"{out['bytes_accessed']:.3e}  coll/dev "
              f"{out['collective_bytes_total']:.3e}")
    return out


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", help="architecture id (repro_torch.configs)")
    ap.add_argument("--shape", choices=list(SHAPES),
                    help="input shape name")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) pair")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 = 512-rank layout")
    ap.add_argument("--both-meshes", action="store_true",
                    help="each pair on the single-pod and multi-pod layouts")
    ap.add_argument("--strategy", choices=["dp", "dp_tp", "fsdp_tp"])
    ap.add_argument("--unrolled", action="store_true",
                    help="recorded only: the port counts at full depth")
    ap.add_argument("--json", help="append JSONL records to this path")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("--arch or --all")

    archs = ARCHS if args.all else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    records, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = dryrun_pair(arch, shape, multi_pod=mp,
                                      strategy=args.strategy,
                                      unrolled=args.unrolled)
                except Exception as e:          # recorded, and the exit
                    traceback.print_exc()       # code says so
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    failures.append(rec)
                records.append(rec)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    ok = sum(r["status"] == "ok" for r in records)
    skip = sum(r["status"] == "skip" for r in records)
    print(f"\ndry-run: {ok} ok, {skip} skip, {len(failures)} FAIL of "
          f"{len(records)} in {time.perf_counter() - t0:.1f} s")
    for f_ in failures:
        print("  FAIL:", f_["arch"], f_["shape"],
              "multi_pod" if f_["multi_pod"] else "", f_["error"][:200])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
