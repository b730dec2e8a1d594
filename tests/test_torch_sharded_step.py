"""The sharded train steps (``dp_tp``, ``fsdp_tp``) of
``repro_torch.distributed.stepfn`` on gloo, against the reference's
``repro.distributed.stepfn.make_train_step`` on the same ``(data, model)``
mesh of host devices.

Each mesh is one launch of ``hvd.run_ranks`` (2 or 4 ``python -c`` ranks
on a ``file://`` store, no network) that runs three smoke configs, each
from the reference's initial params (bridged, then cut into this rank's
shards by ``sharding.shard``) for 2 AdamW steps on the synthetic token
source's batches (B 4, S 16), under each loss variant (``VARIANTS``: the
plain loss, and ``loss_variant="chunked_ce"`` at ``seq_chunk`` 8, two
chunks of S - 1 = 15 positions, one padded).  The reference runs in one
subprocess a file with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed.py`` does), every case and variant on its own
mesh (without remat, which changes no value there), and here once as
its plain one-device jitted step, which its sharded steps must equal.

Cases (mesh (data, model)): ``dp_tp`` at (2, 1) and (1, 2) here,
``fsdp_tp`` at (2, 2) and (1, 4) in ``test_torch_fsdp_step.py``, each
with
- gemma2-27b smoke: 4 query / 2 KV heads, so at model 4 ``fit_spec``
  drops ``model`` from ``wk`` / ``wv`` and each rank attends its one query
  head with the KV head its group reads; tied embeddings;
- deepseek-coder-33b smoke: untied ``lm_head``;
- qwen3-moe-30b-a3b smoke: 4 experts over model 2 and 4 (expert
  parallel), the aux loss over the whole batch.
Two changes to the smoke configs, in both packages: compute in f32, and
for gemma2 and deepseek a vocabulary of 308 instead of 307, so that it
splits over model 2 and 4 and the vocab-parallel embedding, unembedding
and cross-entropy run (qwen3-moe keeps 307: its vocabulary stays
replicated, the fallback); qwen3-moe's dispatch groups are 16 tokens
(one sequence), so that a group never straddles two data ranks (the
reference's groups then equal each rank's).  At (2, 2) the configs run
without remat, so each collective runs once forward and once backward.

Checks: every rank reports the same losses; the losses against the
reference's within rtol 1e-5 and the parameters (gathered by
``sharding.unshard``) within 2e-4 absolute (``tests/test_torch_dp.py``'s
f32 train-step tolerances: AdamW divides each update by its gradient's
running magnitude, so entries whose gradient is near 0 amplify f32
noise); each rank's bytes of params and AdamW state equal
``sharding.local_bytes`` of the specs exactly; the data group's
collectives a step equal a formula from the specs (all_gather and
reduce_scatter of every leaf split over ``data``, the gradient
all_reduce of the rest, the metrics, the MoE aux loss's means); at
(2, 2) the model group's all_reduce bytes equal a formula from the
activations' shapes (for the chunked loss, from its chunks: each one's
vocab-parallel cross-entropy in the forward and in its checkpoint's
recompute).  On the same ranks the chunked loss's steps equal the plain
loss's (losses, params, and the data group's collectives byte for
byte).  Then the launcher ``--smoke --strategy fsdp_tp``
at world size 4 (model axis 1): its losses equal the ``dp`` launcher's at
the same world size within rtol 1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import hvd
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import stepfn
from repro_torch.launch.mesh import AbstractMesh

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4
SEQ, BATCH, STEPS, LR = 16, 4, 2, 1e-3
# the chunked cross-entropy at seq_chunk 8: S - 1 = 15 positions make two
# chunks, the second with one padded position
SEQ_CHUNK = 8
VARIANTS = {"": {}, "-chunked": {"loss_variant": "chunked_ce",
                                 "seq_chunk": SEQ_CHUNK}}
ARCHS = ["gemma2-27b", "deepseek-coder-33b", "qwen3-moe-30b-a3b"]
OVERRIDES = {"gemma2-27b": {"vocab_size": 308},
             "deepseek-coder-33b": {"vocab_size": 308},
             "qwen3-moe-30b-a3b": {"moe_group_size": SEQ}}
MESHES = {"dp_tp-2x1": ("dp_tp", (2, 1)), "dp_tp-1x2": ("dp_tp", (1, 2))}
FSDP_MESHES = {"fsdp_tp-2x2": ("fsdp_tp", (2, 2)),
               "fsdp_tp-1x4": ("fsdp_tp", (1, 4))}
NO_REMAT = {"fsdp_tp-2x2"}


def _cfg_kw(arch, label):
    kw = dict(OVERRIDES[arch], dtype="float32")
    if label in NO_REMAT:
        kw["remat"] = False
    return kw


REFERENCE = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import optim
    from repro.checkpoint.ckpt import _flatten_with_paths
    from repro.configs import get_smoke_config
    from repro.configs.base import InputShape
    from repro.data import SyntheticTokenSource, TokenDatasetSpec
    from repro.distributed import stepfn
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as T
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    shape = InputShape("t", spec["seq"], spec["batch"], "train")
    res = {}
    flat = lambda t: {k: np.asarray(v)
                      for k, v in _flatten_with_paths(t).items()}
    for arch, over in spec["archs"].items():
        base = get_smoke_config(arch).with_(**over)
        init = jax.jit(T.init_params, static_argnums=0)(
            base, jax.random.PRNGKey(0))
        np.savez(os.path.join(out, f"init-{arch}.npz"), **flat(init))
        src = SyntheticTokenSource(TokenDatasetSpec(
            base.vocab_size, spec["seq"], spec["batch"]))
        batches = [{k: jnp.asarray(v) for k, v in src.batch(i).items()}
                   for i in range(spec["steps"])]
        opt = optim.adamw(spec["lr"], clip_norm=1.0)
        for label, (strategy, mshape) in spec["cases"].items():
            cfg = base.with_(remat=False)
            mesh = make_mesh(tuple(mshape), ("data", "model"))
            for variant, kw in spec["variants"].items():
                step, _, _ = stepfn.make_train_step(cfg, opt, mesh, strategy,
                                                    shape, **kw)
                p = jax.tree.map(jnp.copy, init)
                st = opt.init(p)
                losses = []
                for b in batches:
                    p, st, m = step(p, st, b)
                    losses.append(float(m["loss"]))
                res[f"{arch}/{label}{variant}"] = losses
                np.savez(os.path.join(out, f"ref-{arch}-{label}{variant}.npz"),
                         **flat(p))
        if arch in spec["single"]:
            def sstep(p, s, b):
                (l, _), g = jax.value_and_grad(
                    lambda q: T.lm_loss(q, base, b), has_aux=True)(p)
                u, s = opt.update(g, s, p)
                return optim.apply_updates(p, u), s, l
            sstep = jax.jit(sstep)
            p, st, losses = init, opt.init(init), []
            for b in batches:
                p, st, l = sstep(p, st, b)
                losses.append(float(l))
            res[f"{arch}/single"] = losses
            np.savez(os.path.join(out, f"ref-{arch}-single.npz"), **flat(p))
    json.dump(res, open(os.path.join(out, "ref.json"), "w"))
""")

PORT = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge, optim
from repro_torch.configs import get_smoke_config
from repro_torch.core import hvd
from repro_torch.data import SyntheticTokenSource, TokenDatasetSpec
from repro_torch.distributed import sharding as sh, stepfn
from repro_torch.launch.mesh import make_mesh
store, out, ref_dir = sys.argv[1], sys.argv[2], sys.argv[3]
spec = json.loads(sys.argv[4])
res = {}
with hvd.init("cpu", init_method=store):
    groups = make_mesh(tuple(spec["mesh"]), ("data", "model"))
    rank = int(os.environ["RANK"])
    for arch, over in spec["archs"].items():
        cfg = get_smoke_config(arch).with_(**over)
        init = np.load(os.path.join(ref_dir, f"init-{arch}.npz"))
        opt = optim.adamw(spec["lr"], clip_norm=1.0)
        pspec, ospec = stepfn.state_specs(cfg, opt, spec["strategy"], groups)
        for variant, kw in spec["variants"].items():
            # fresh leaves each variant: a shard may alias its whole leaf,
            # which AdamW updates in place
            full = bridge.from_flat({k: init[k] for k in init.files})
            params, state = stepfn.shard_state(full, cfg, opt,
                                               spec["strategy"], groups)
            del full
            step = stepfn.make_train_step(cfg, opt, groups,
                                          strategy=spec["strategy"],
                                          device="cpu", **kw)
            src = SyntheticTokenSource(TokenDatasetSpec(
                cfg.vocab_size, spec["seq"], spec["batch"]))
            losses, counts = [], []
            for i in range(spec["steps"]):
                groups.reset_counts()
                params, state, m = step(params, state, src.batch(i))
                losses.append(float(m["loss"]))
                counts.append({"/".join(k): {n: list(v) for n, v in
                                             g.kinds.items()}
                               for k, g in groups._groups.items()})
            def tree_bytes(t):
                if isinstance(t, dict):
                    return sum(tree_bytes(v) for v in t.values())
                return t.numel() * t.element_size()
            res[arch + variant] = {
                "losses": losses, "counts": counts,
                "param_bytes": tree_bytes(params),
                "state_bytes": tree_bytes(state),
                "want_param_bytes": sh.local_bytes(
                    pspec, params, {a: 1 for a in groups.shape}),
                "want_state_bytes": sh.local_bytes(
                    ospec, state, {a: 1 for a in groups.shape})}
            whole = sh.unshard(params, pspec, groups)
            if rank == 0:
                np.savez(os.path.join(out, f"port-{arch}{variant}.npz"),
                         **bridge.to_flat(whole))
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
"""


def run_reference(out, meshes, single=()):
    """The reference's sharded steps on ``meshes`` (and its one-device
    step for the archs in ``single``), in one subprocess on 4 host
    devices.  Returns ``(out, {"<arch>/<label>": losses})``."""
    spec = {"seq": SEQ, "batch": BATCH, "steps": STEPS, "lr": LR,
            "single": list(single), "variants": VARIANTS,
            "archs": {a: dict(OVERRIDES[a], dtype="float32") for a in ARCHS},
            "cases": {label: [strategy, list(shape)]
                      for label, (strategy, shape) in meshes.items()}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        json.dumps(spec)], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return out, json.loads((out / "ref.json").read_text())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("reference"), MESHES,
                         single=("gemma2-27b",))


def test_reference_sharded_step_is_its_one_device_step(reference):
    """The reference's own check: its sharded steps give its plain
    one-device step's losses and params."""
    out, ref = reference
    single = dict(np.load(out / "ref-gemma2-27b-single.npz"))
    for label in MESHES:
        np.testing.assert_allclose(ref[f"gemma2-27b/{label}"],
                                   ref["gemma2-27b/single"], rtol=LOSS_RTOL)
        got = dict(np.load(out / f"ref-gemma2-27b-{label}.npz"))
        for k in single:
            np.testing.assert_allclose(got[k], single[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


def _leaf_bytes(tree, specs, mesh_shape, pred):
    """{path: (local bytes, whole bytes)} of the f32 leaves whose spec
    satisfies ``pred``."""
    out = {}

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], f"{path}/{k}" if path else k)
            return
        if pred(s):
            n = 1
            for d in sh.local_shape(s, tuple(t.shape), mesh_shape):
                n *= d
            out[path] = (4 * n, 4 * t.numel())
    walk(tree, specs, "")
    return out


def _data_formula(cfg, strategy, mesh_shape, specs, params, local_batch):
    """The data group's collectives a step: {kind: [calls, bytes]}."""
    D = mesh_shape["data"]
    sharded = _leaf_bytes(params, specs, mesh_shape,
                          lambda s: "data" in sh.axes_of(s))
    rest = _leaf_bytes(params, specs, mesh_shape,
                       lambda s: "data" not in sh.axes_of(s))
    want = {}
    if sharded:
        # a layer group's leaves gathered in the forward and again in the
        # remat's recompute, the others (embed, lm_head) once; every
        # gather's backward reduce-scatters the gradient of what it
        # gathered (D shards)
        from repro_torch.models.transformer import layer_pattern
        gathers = 2 if cfg.remat else 1
        groups = cfg.num_layers // len(layer_pattern(cfg))
        n_ag = b_ag = n_rs = b_rs = 0
        for path, (loc, _) in sharded.items():
            # a stacked leaf is gathered one layer group at a time
            g, n = (gathers, groups) if path.startswith("layers") else (1, 1)
            n_ag, b_ag = n_ag + g * n, b_ag + g * loc
            n_rs, b_rs = n_rs + n, b_rs + D * loc
        want["all_gather"] = [n_ag, b_ag]
        want["reduce_scatter"] = [n_rs, b_rs]
    # the fused f32 gradient all_reduce of the leaves replicated over data,
    # and the four f32 metrics
    n_ar, b_ar = (1 if rest else 0) + 1, sum(loc for loc, _ in
                                             rest.values()) + 16
    if cfg.family == "moe":
        # each layer's router means over the batch: me and ce in the
        # forward (and the recompute), me's gradient in the backward
        E = cfg.num_experts
        per = (4 if cfg.remat else 2) + 1
        n_ar += cfg.num_layers * per
        b_ar += cfg.num_layers * per * 4 * E
    want["all_reduce"] = [n_ar, b_ar]
    return want


def _model_formula(cfg, specs, mesh_shape, local_batch, seq_chunk=None):
    """The model group's all_reduce bytes a step without remat: each
    Megatron f (backward) and g (forward) once, the vocab-parallel
    cross-entropy's max, sum and target logit (f32), the experts' combine
    (f32) and gate weights' gradient (f32), the split of the dispatch
    buffer (all_gather, backward).  ``seq_chunk``: the chunked loss, each
    chunk checkpointed whatever ``cfg.remat``: the unembedding's f over
    the S - 1 positions padded to a multiple of ``seq_chunk``, and the
    max, sum and target logit in the forward and again in the recompute
    (the target logit's all_reduce comes before the chunk's last saved
    tensor, the valid mask its product saves, so early stopping keeps
    all three)."""
    B, S, d = local_batch, SEQ, cfg.d_model
    act = 4 * B * S * d                     # one (B, S, d) f32 activation
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    m = mesh_shape["model"]
    lay = specs["layers"]
    ar = ag = 0
    q_split = sh.model_dim(lay["attn"]["wq"]["w"]) is not None
    kv_split = sh.model_dim(lay["attn"]["wk"]["w"]) is not None
    wo_split = sh.model_dim(lay["attn"]["wo"]["w"]) is not None
    per_layer = 0
    if q_split or kv_split:
        per_layer += act                    # f on the norm's output
    if q_split and not kv_split:
        per_layer += 2 * 4 * B * S * kv * dh    # f on every K and V head
    if wo_split:
        per_layer += act                    # g of the row-parallel wo
        if not q_split:
            ag += 4 * B * S * (h * dh) // m  # wo's split: gather backward
    if "mlp" in lay and sh.model_dim(lay["mlp"]["wi"]["w"]) is not None:
        per_layer += 2 * act                # f in, g out
    if "moe" in lay and sh.model_dim(lay["moe"]["wi"]) is not None:
        from repro_torch.models import moe
        T = B * S
        Tg = moe.group_size(T, cfg)
        G, C = T // Tg, moe.expert_capacity(Tg, cfg)
        K = cfg.num_experts_per_tok
        per_layer += act + 4 * G * Tg * K   # combine g, gates' f
        ag += cfg.num_layers * 4 * G * (cfg.num_experts // m) * C * d
    ar += cfg.num_layers * per_layer
    vocab = (specs["embed"]["table"] if cfg.tie_embeddings
             else specs["lm_head"]["w"])
    if sh.model_dim(vocab) is not None:
        if sh.model_dim(specs["embed"]["table"]) is not None:
            ar += act                       # the embedding's g
        if seq_chunk is None:
            ar += act + 3 * 4 * B * (S - 1)  # unembed f; max, sum, target
        else:
            n = S - 1 + (-(S - 1)) % seq_chunk
            ar += 4 * B * n * d + 2 * 3 * 4 * B * n
    elif sh.model_dim(specs["embed"]["table"]) is not None:
        ar += act
    return ar, ag


def launch_mesh(label, reference, tmp_path):
    """One mesh's launch: the three configs under each of ``VARIANTS``,
    from the same initial shards.  Returns ``(tmp_path, runs)``, each
    rank's results."""
    out, _ = reference
    strategy, shape = {**MESHES, **FSDP_MESHES}[label]
    spec = {"strategy": strategy, "mesh": list(shape), "seq": SEQ,
            "batch": BATCH, "steps": STEPS, "lr": LR, "variants": VARIANTS,
            "archs": {a: _cfg_kw(a, label) for a in ARCHS}}
    world = shape[0] * shape[1]
    hvd.run_ranks(PORT, world, tmp_path, str(out), json.dumps(spec),
                  timeout=300)
    return tmp_path, [json.loads((tmp_path / f"rank{r}.json").read_text())
                      for r in range(world)]


def launches(tmp_path_factory, reference):
    """``get(label)``: :func:`launch_mesh` of ``label``, run once a
    module (the plain and chunked tests read the same launch)."""
    done = {}

    def get(label):
        if label not in done:
            done[label] = launch_mesh(label, reference,
                                      tmp_path_factory.mktemp(label))
        return done[label]
    return get


def check_mesh(label, reference, launch, variant=""):
    """One mesh's launch of the three configs under loss ``variant``,
    checked as the module's docstring says."""
    out, ref = reference
    tmp_path, runs = launch
    strategy, shape = {**MESHES, **FSDP_MESHES}[label]
    mesh_shape = {"data": shape[0], "model": shape[1]}
    mesh = AbstractMesh(shape, ("data", "model"))
    seq_chunk = VARIANTS[variant].get("seq_chunk")
    for arch in ARCHS:
        key = arch + variant
        cfg = get_smoke_config(arch).with_(**_cfg_kw(arch, label))
        for r in runs:
            assert r[key]["losses"] == runs[0][key]["losses"], key
            assert r[key]["param_bytes"] == r[key]["want_param_bytes"]
            assert r[key]["state_bytes"] == r[key]["want_state_bytes"]
        np.testing.assert_allclose(runs[0][key]["losses"],
                                   ref[f"{arch}/{label}{variant}"],
                                   rtol=LOSS_RTOL, err_msg=key)
        want = dict(np.load(out / f"ref-{arch}-{label}{variant}.npz"))
        got = dict(np.load(tmp_path / f"port-{key}.npz"))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{key} {k}")
        params = stepfn.params_struct(cfg)
        specs = sh.params_pspec(params, cfg, strategy, mesh)
        local_batch = BATCH // shape[0]
        data = _data_formula(cfg, strategy, mesh_shape, specs, params,
                             local_batch)
        for step in runs[0][key]["counts"]:
            assert {k: list(v) for k, v in step["data"].items()} == data, \
                (key, step["data"], data)
            if label in NO_REMAT:
                ar, ag = _model_formula(cfg, specs, mesh_shape, local_batch,
                                        seq_chunk)
                got_m = step["model"]
                assert got_m["all_reduce"][1] == ar, (key, got_m, ar)
                assert got_m.get("all_gather", [0, 0])[1] == ag, \
                    (key, got_m, ag)


def check_chunked_equals_plain(label, launch):
    """On the same ranks, from the same shards and batches, the chunked
    loss's steps equal the plain loss's: the losses within ``LOSS_RTOL``,
    the params within ``PARAM_ATOL``, and each step's data-group
    collectives byte for byte."""
    tmp_path, runs = launch
    for arch in ARCHS:
        plain, chunked = runs[0][arch], runs[0][arch + "-chunked"]
        np.testing.assert_allclose(chunked["losses"], plain["losses"],
                                   rtol=LOSS_RTOL, err_msg=arch)
        for r in runs:
            for a, b in zip(r[arch]["counts"], r[arch + "-chunked"]["counts"]):
                assert a["data"] == b["data"], (arch, a["data"], b["data"])
        want = dict(np.load(tmp_path / f"port-{arch}.npz"))
        got = dict(np.load(tmp_path / f"port-{arch}-chunked.npz"))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{arch} {k}")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, reference):
    return launches(tmp_path_factory, reference)


@pytest.mark.parametrize("label", list(MESHES))
def test_sharded_steps_match_the_reference(label, reference, mesh_runs):
    check_mesh(label, reference, mesh_runs(label))


@pytest.mark.parametrize("label", list(MESHES))
def test_chunked_sharded_steps_match_the_reference(label, reference,
                                                   mesh_runs):
    check_mesh(label, reference, mesh_runs(label), "-chunked")


@pytest.mark.parametrize("label", list(MESHES))
def test_chunked_sharded_loss_equals_the_plain_one(label, mesh_runs):
    check_chunked_equals_plain(label, mesh_runs(label))


LAUNCH = """
import json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import train
store, out = sys.argv[1], sys.argv[2]
argv = json.loads(sys.argv[3]) + ["--init-method", store]
res = train.main(argv + ["--ckpt-dir", os.path.join(out, "ckpt"),
                         "--ckpt-every", "2"])
if int(os.environ["RANK"]) == 0:
    json.dump({k: res[k] for k in ("losses", "strategy", "mesh",
               "collectives_per_step", "model_collectives_per_step")},
              open(os.path.join(out, "run.json"), "w"))
"""


def test_launcher_fsdp_tp_at_world_size_4_matches_dp(tmp_path):
    """``--smoke --strategy fsdp_tp`` at world size 4: the host mesh (4,
    1); the same losses as ``--strategy dp`` at world size 4, and a
    checkpoint of whole leaves (gathered from the shards) holding the
    same params and AdamW state as dp's within the f32 step tolerance."""
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu", "--dtype",
            "float32", "--steps", "2", "--seq-len", "16", "--global-batch",
            "8"]
    got = {}
    for strategy in ("dp", "fsdp_tp"):
        d = tmp_path / strategy
        d.mkdir()
        hvd.run_ranks(LAUNCH, 4, d, json.dumps(argv + ["--strategy",
                                                       strategy]))
        got[strategy] = json.loads((d / "run.json").read_text())
    f = got["fsdp_tp"]
    assert f["strategy"] == "fsdp_tp" and f["mesh"] == {"data": 4,
                                                        "model": 1}
    np.testing.assert_allclose(f["losses"], got["dp"]["losses"],
                               rtol=LOSS_RTOL)
    assert all(c["calls"] > 0 for c in f["model_collectives_per_step"])
    ck = {s: np.load(tmp_path / s / "ckpt" / "step_000000002" / "arrays.npz")
          for s in got}
    assert sorted(ck["fsdp_tp"].files) == sorted(ck["dp"].files)
    for k in ck["dp"].files:
        np.testing.assert_allclose(ck["fsdp_tp"][k], ck["dp"][k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
