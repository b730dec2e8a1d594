"""Horovod-style data parallelism and the parameter-server baseline on
``torch.distributed`` (gloo), at world sizes 2 and 4, and the 3DGAN entry
point.

Each scenario is one launch: the ranks are subprocesses running a ``python
-c`` program that imports only torch, numpy and the port, joined through a
``file://`` store in the test's temporary directory (no network).  They
write what they computed to ``.npz`` / ``.json`` files; the checks run
here, against the reference where one is named.

Tolerances:
- collectives on integer-valued f32 and int64 tensors: exact;
- a DP step pair against the reference's jitted single-device pair on the
  whole batch: losses rtol 1e-5, every parameter within 1e-5 absolute, as
  ``test_torch_gan3d.py``'s step pairs (the mean of the ranks' shard
  means rounds differently from one mean over the batch); the metric
  ``fake_total_e`` rtol 1e-4: it sums 25^3 positive cells of each
  generated image, and after the first G update the ~1e-6 parameter
  differences RMSProp leaves on gradient entries near its eps (1e-8)
  move it by up to 2.5e-5 relative (observed);
- the replicas of every rank: bitwise identical;
- the parameter server against hvd: losses within 1e-3 (the reference's
  ``tests/test_distributed.py`` bound) and parameters within 1e-5;
- hierarchical against flat allreduce: losses within 1e-5, parameters
  within 1e-5; the outer (``pod``) group's bytes are half the flat
  gradient allreduce's, plus one f32 of padding for an odd count.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import hvd

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
STEP_ATOL = 1e-5
PS_LOSS_ATOL = 1e-3
TOTAL_E_RTOL = 1e-4
SMOKE = dict(g_base=8, d_base=4)
BATCH = 8
PAIRS = 2
D_LR, G_LR = 1.5e-4, 3e-4

_PRELUDE = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge, optim
from repro_torch.core import hvd, paramserver
from repro_torch.models import gan3d as G
store, out = sys.argv[1], sys.argv[2]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
layout = {"data": 2} if world == 2 else {"pod": 2, "data": 2}
"""

COLLECTIVES = _PRELUDE + """
res = {}
with hvd.init("cpu", init_method=store) as dev:
    groups = hvd.axis_groups(layout)
    w = groups.world
    res["ranks"] = {",".join(a): groups[a].ranks for a in
                    [("data",), ("pod",), ("pod", "data")] if all(
                        x in layout for x in a)}
    res["rank"] = {",".join(a): hvd.rank(groups[a]) for a in
                   [("data",), ("pod", "data")] if all(x in layout for x in a)}
    res["size"] = hvd.size(w)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)
                 * (rank + 1),
            "n": torch.tensor([rank, 10 * rank], dtype=torch.int64),
            "s": torch.tensor(float(rank))}
    mean = hvd.allreduce({"a": tree["a"], "s": tree["s"]}, w)
    total = hvd.allreduce(tree, w, average=False)
    res["mean_a"] = mean["a"].tolist(); res["mean_s"] = float(mean["s"])
    res["sum_a"] = total["a"].tolist(); res["sum_n"] = total["n"].tolist()
    res["input_kept"] = tree["a"].tolist()
    gat = hvd.allgather({"rows": torch.tensor([[rank, 1.0], [rank, 2.0]]),
                         "s": torch.tensor(float(rank))}, w)
    res["gather_rows"] = gat["rows"].tolist(); res["gather_s"] = gat["s"].tolist()
    b = hvd.broadcast({"x": torch.full((3,), float(rank)),
                       "i": torch.tensor([rank])}, w, root=1)
    res["bcast"] = [b["x"].tolist(), b["i"].tolist()]
    if "pod" in layout:
        odd = {"v": torch.arange(7, dtype=torch.float32) * (rank + 1)}
        groups.reset_counts()
        h = hvd.hierarchical_allreduce(odd, groups["data"], groups["pod"],
                                       average=False)
        res["hier"] = h["v"].tolist()
        res["hier_counts"] = {",".join(k): v for k, v in
                              groups.counts().items()}
    groups.reset_counts()
    hvd.allreduce({"a": tree["a"]}, w)
    res["flat_counts"] = {",".join(k): v for k, v in groups.counts().items()}
json.dump(res, open(os.path.join(out, f"coll{rank}.json"), "w"))
"""

TRAINING = _PRELUDE + """
mode = sys.argv[3]                       # "dp" or "hier"
init = np.load(os.path.join(out, "init.npz"))
cfg = G.GAN3DConfig(g_base=8, d_base=4)
n = init["images"].shape[1]
rows = slice(rank * n // world, (rank + 1) * n // world)
res = {}
with hvd.init("cpu", init_method=store) as dev:
    groups = hvd.axis_groups(layout)
    if mode == "dp":
        ev = hvd.make_eval_step(lambda d, g, b, z: G.d_loss(d, g, cfg, b, z),
                                groups)
        res["eval"] = {k: float(v) for k, v in ev(
            bridge.gan_from_flat({k[2:]: init[k] for k in init.files
                                  if k.startswith("d/")}),
            bridge.gan_from_flat({k[2:]: init[k] for k in init.files
                                  if k.startswith("g/")}),
            {"images": torch.from_numpy(init["images"][0][rows]),
             "energies": torch.from_numpy(init["energies"][0][rows])},
            torch.from_numpy(init["z1"][0][rows])).items()}
    runs = ["hvd", "ps"] if mode == "dp" else ["flat", "hier"]
    for run in runs:
        gp = bridge.gan_from_flat({k[2:]: init[k] for k in init.files
                                   if k.startswith("g/")})
        dp = bridge.gan_from_flat({k[2:]: init[k] for k in init.files
                                   if k.startswith("d/")})
        d_opt = optim.rmsprop(%(d_lr)r, clip_norm=1.0)
        g_opt = optim.rmsprop(%(g_lr)r, clip_norm=1.0)
        ds, gs = d_opt.init(dp), g_opt.init(gp)
        dl = lambda d, g, b, z: G.d_loss(d, g, cfg, b, z)
        gl = lambda g, d, b, z: G.g_loss(g, d, cfg, b, z)
        if run == "ps":
            d_step = paramserver.make_train_step(dl, d_opt, groups)
            g_step = paramserver.make_train_step(gl, g_opt, groups)
        else:
            hier = run == "hier"
            d_step = hvd.make_train_step(dl, d_opt, groups, hierarchical=hier)
            g_step = hvd.make_train_step(gl, g_opt, groups, hierarchical=hier)
        losses, counts = [], []
        for i in range(init["images"].shape[0]):
            batch = {"images": torch.from_numpy(init["images"][i][rows]),
                     "energies": torch.from_numpy(init["energies"][i][rows])}
            groups.reset_counts()
            dp, ds, dm = d_step(dp, ds, gp, batch,
                                torch.from_numpy(init["z1"][i][rows]))
            c_d = {",".join(k): v for k, v in groups.counts().items()}
            groups.reset_counts()
            gp, gs, gm = g_step(gp, gs, dp, batch,
                                torch.from_numpy(init["z2"][i][rows]))
            c_g = {",".join(k): v for k, v in groups.counts().items()}
            losses.append({k: float(v) for k, v in {**dm, **gm}.items()
                           if k != "loss"})
            counts.append({"d": c_d, "g": c_g})
        res[run] = {"losses": losses, "counts": counts}
        flat = {"g/" + k: v for k, v in bridge.gan_to_flat(gp).items()}
        flat.update({"d/" + k: v for k, v in bridge.gan_to_flat(dp).items()})
        np.savez(os.path.join(out, f"{run}{rank}.npz"), **flat)
json.dump(res, open(os.path.join(out, f"train{rank}.json"), "w"))
""" % {"d_lr": D_LR, "g_lr": G_LR}


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_collectives_give_exact_values(world, tmp_path):
    hvd.run_ranks(COLLECTIVES, world, tmp_path)
    res = [json.loads((tmp_path / f"coll{r}.json").read_text())
           for r in range(world)]
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    tri = world * (world + 1) / 2                 # sum of (rank + 1)
    for r, x in enumerate(res):
        assert x["size"] == world
        if world == 2:
            assert x["ranks"] == {"data": [0, 1]}
            assert x["rank"] == {"data": r}
        else:                                     # row-major (pod, data)
            pod, data = divmod(r, 2)
            assert x["ranks"] == {"data": [2 * pod, 2 * pod + 1],
                                  "pod": [data, data + 2],
                                  "pod,data": [0, 1, 2, 3]}
            assert x["rank"] == {"data": data, "pod,data": r}
        assert np.array_equal(x["mean_a"], a * tri / world)
        assert x["mean_s"] == sum(range(world)) / world
        assert np.array_equal(x["sum_a"], a * tri)
        assert x["sum_n"] == [sum(range(world)), 10 * sum(range(world))]
        assert np.array_equal(x["input_kept"], a * (r + 1))
        assert x["gather_rows"] == [[q, v] for q in range(world)
                                    for v in (1.0, 2.0)]
        assert x["gather_s"] == [float(q) for q in range(world)]
        assert x["bcast"] == [[1.0] * 3, [1]]
        world_key = "data" if world == 2 else "pod,data"
        # one fused all_reduce of the 6 f32 leaf elements: 24 bytes
        assert x["flat_counts"][world_key] == [1, 24]
        if world == 4:
            assert np.array_equal(x["hier"], np.arange(7) * tri)
            # 7 elements padded to 8: reduce-scatter 8 and all-gather 4 on
            # the inner group, all_reduce of the 4-element shard on the pod
            assert x["hier_counts"]["pod"] == [1, 16]
            assert x["hier_counts"]["data"] == [2, 32 + 16]
            assert x["hier_counts"]["pod,data"] == [0, 0]


# ---------------------------------------------------------------------------
# training: DP against the reference, replicas, PS, hierarchical
# ---------------------------------------------------------------------------

def _flat(tree):
    from repro.checkpoint.ckpt import _flatten_with_paths
    return {k: np.asarray(v) for k, v in _flatten_with_paths(tree).items()}


@pytest.fixture(scope="module")
def reference():
    """Smoke-width reference weights, PAIRS global batches and z, and the
    reference's jitted single-device (D, G) pairs on the whole batch."""
    import jax
    import jax.numpy as jnp

    from repro import optim as jopt
    from repro.data import CalorimeterSpec, generate_batch
    from repro.models import gan3d as JG
    cfg = JG.GAN3DConfig(**SMOKE)
    key = jax.random.PRNGKey(0)
    jg = jax.jit(JG.init_generator, static_argnums=1)(key, cfg)
    jd = jax.jit(JG.init_discriminator, static_argnums=1)(
        jax.random.fold_in(key, 1), cfg)
    init = {"g/" + k: v for k, v in _flat(jg).items()}
    init.update({"d/" + k: v for k, v in _flat(jd).items()})
    data = [generate_batch(CalorimeterSpec(), BATCH, i) for i in range(PAIRS)]
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, PAIRS, BATCH, cfg.latent_dim)).astype(
        np.float32)
    init.update(images=np.stack([d["images"] for d in data]),
                energies=np.stack([d["energies"] for d in data]),
                z1=z[0], z2=z[1])

    d_opt, g_opt = jopt.rmsprop(D_LR, clip_norm=1.0), jopt.rmsprop(
        G_LR, clip_norm=1.0)

    @jax.jit
    def pair(dp, ds, gp, gs, b, z1, z2):
        gd, dm = jax.grad(JG.d_loss, has_aux=True)(dp, gp, cfg, b, z1)
        u, ds = d_opt.update(gd, ds, dp)
        dp = jopt.apply_updates(dp, u)
        gg, gm = jax.grad(JG.g_loss, has_aux=True)(gp, dp, cfg, b, z2)
        u, gs = g_opt.update(gg, gs, gp)
        return dp, ds, jopt.apply_updates(gp, u), gs, {**dm, **gm}

    b0 = {"images": jnp.asarray(init["images"][0]),
          "energies": jnp.asarray(init["energies"][0])}
    _, eval0 = JG.d_loss(jd, jg, cfg, b0, jnp.asarray(z[0, 0]))
    ds, gs = d_opt.init(jd), g_opt.init(jg)
    losses = []
    for i in range(PAIRS):
        b = {"images": jnp.asarray(init["images"][i]),
             "energies": jnp.asarray(init["energies"][i])}
        jd, ds, jg, gs, m = pair(jd, ds, jg, gs, b, jnp.asarray(z[0, i]),
                                 jnp.asarray(z[1, i]))
        losses.append({k: float(v) for k, v in m.items()})
    final = {"g/" + k: v for k, v in _flat(jg).items()}
    final.update({"d/" + k: v for k, v in _flat(jd).items()})
    return {"init": init, "losses": losses, "final": final,
            "eval": {k: float(v) for k, v in eval0.items()},
            "g_params": sum(v.size for k, v in final.items()
                            if k.startswith("g/")),
            "d_params": sum(v.size for k, v in final.items()
                            if k.startswith("d/"))}


def _train(reference, world, mode, out):
    np.savez(out / "init.npz", **reference["init"])
    hvd.run_ranks(TRAINING, world, out, mode)
    res = [json.loads((out / f"train{r}.json").read_text())
           for r in range(world)]
    params = {run: [dict(np.load(out / f"{run}{r}.npz"))
                    for r in range(world)] for run in res[0] if run != "eval"}
    return res, params


def _assert_replicas_identical(params):
    for run, per_rank in params.items():
        for r, p in enumerate(per_rank[1:], 1):
            for k, v in per_rank[0].items():
                assert np.array_equal(p[k], v), (run, r, k)


def _assert_params_close(got, want, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_equals_the_whole_batch_reference_step_and_ps_tracks_it(
        world, reference, tmp_path):
    res, params = _train(reference, world, "dp", tmp_path)
    _assert_replicas_identical(params)
    for x in res:                               # metrics allreduced: equal
        assert x == res[0]
    hvd_run, ps_run = res[0]["hvd"], res[0]["ps"]
    # the eval step on the shards: the whole batch's metrics, and loss
    ev, want = res[0]["eval"], reference["eval"]
    assert ev.keys() == {*want, "loss"}
    for k in want:
        np.testing.assert_allclose(ev[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert ev["loss"] == ev["d_loss"]
    for got, want in zip(hvd_run["losses"], reference["losses"]):
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["fake_total_e"], want["fake_total_e"],
                                   rtol=TOTAL_E_RTOL)
        # accuracies are fractions of the batch: the same on every shard
        # split, as long as no logit sits within rounding of 0
        for k in ("acc_real", "acc_fake"):
            assert got[k] == want[k], k
    _assert_params_close(params["hvd"][0], reference["final"], STEP_ATOL)
    for a, b in zip(ps_run["losses"], hvd_run["losses"]):
        for k in a:
            assert abs(a[k] - b[k]) <= PS_LOSS_ATOL * max(1.0, abs(b[k])), k
    _assert_params_close(params["ps"][0], params["hvd"][0], STEP_ATOL)
    # hvd: one fused gradient all_reduce and one of the metrics a step,
    # the gradient's bytes exactly (d_loss, acc_real, acc_fake, loss: 16 B;
    # g_loss, fake_total_e, loss: 12 B)
    key = "data" if world == 2 else "pod,data"
    for c in hvd_run["counts"]:
        assert c["d"][key] == [2, 4 * reference["d_params"] + 16]
        assert c["g"][key] == [2, 4 * reference["g_params"] + 12]
    # the parameter server: a gather per gradient leaf, a broadcast of the
    # new parameters, the metrics' all_reduce
    n_leaves = sum(1 for k in reference["final"] if k.startswith("d/"))
    for c in ps_run["counts"]:
        assert c["d"][key] == [n_leaves + 2, 2 * 4 * reference["d_params"]
                               + 16]


def test_hierarchical_allreduce_trains_like_flat_with_half_the_pod_bytes(
        reference, tmp_path):
    res, params = _train(reference, 4, "hier", tmp_path)
    _assert_replicas_identical(params)
    flat, hier = res[0]["flat"], res[0]["hier"]
    for a, b in zip(hier["losses"], flat["losses"]):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(b[k])), k
    _assert_params_close(params["hier"][0], params["flat"][0], STEP_ATOL)
    for which, metrics in (("d", 16), ("g", 12)):
        n = reference[f"{which}_params"]
        for cf, ch in zip(flat["counts"], hier["counts"]):
            assert cf[which]["pod,data"] == [2, 4 * n + metrics]
            assert cf[which]["pod"] == [0, 0]
            # the pod link carries half the gradient, padded to even
            assert ch[which]["pod"] == [1, 4 * ((n + 1) // 2)]
            assert ch[which]["pod,data"] == [1, metrics]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_train_3dgan_runs_on_the_cpu_at_the_smoke_config():
    from repro_torch.launch import train_3dgan
    run = train_3dgan.main(["--smoke", "--device", "cpu", "--steps", "2",
                            "--batch", "4"])
    assert run["backend"] == "gloo" and run["world_size"] == 1
    assert len(run["d_losses"]) == len(run["g_losses"]) == 2
    assert np.isfinite(run["d_losses"] + run["g_losses"]).all()
    assert (run["g_params"], run["d_params"]) == (696_169, 23_603)
    # at world size 1 the collectives are still issued: a gradient and a
    # metrics all_reduce for each of the two steps
    for c in run["collectives_per_step"]:
        assert c == {"calls": 4,
                     "bytes": 4 * (696_169 + 23_603) + 16 + 12}
    assert np.isfinite(run["energy_corr"])
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_physics_validation_flow_on_the_cpu():
    """The port's observables equal the reference's on the same showers;
    ``run`` reports the reference's five rows."""
    from benchmarks import physics_validation as jpv
    from repro_torch.benchmarks import physics_validation as ppv
    from repro_torch.data import CalorimeterSpec, generate_batch
    a = generate_batch(CalorimeterSpec(), 6, step=1)["images"]
    b = generate_batch(CalorimeterSpec(), 6, step=2)["images"]
    for got, want in zip(ppv.profiles(a), jpv.profiles(a)):
        assert np.array_equal(got, want)
    assert ppv.chi2_distance(ppv.profiles(a)[0], ppv.profiles(b)[0]) == \
        jpv.chi2_distance(jpv.profiles(a)[0], jpv.profiles(b)[0])
    rows = ppv.run(train_steps=2, batch=2, eval_events=4, device="cpu")
    assert [r[0] for r in rows] == [
        "physics/train", "physics/longitudinal_chi2", "physics/lateral_chi2",
        "physics/shower_max_depth", "physics/energy_response_corr"]
    assert rows[0][1] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_nccl_dp_step_on_the_card_matches_the_cpu_step(cuda):
    """``hvd.init("cuda")`` makes an NCCL group (world size 1); one (D, G)
    pair through ``hvd.make_train_step`` on the card against the same pair
    on the CPU, held to ``chip_smoke.py``'s tolerance."""
    import torch.distributed as dist

    from repro_torch.core import hvd
    cs = _chip_smoke()
    with hvd.init("cuda") as dev:
        assert dist.get_backend() == "nccl"
        cs.gan_card_vs_cpu(torch, dev, batch=4, pairs=1, full_width=False)
