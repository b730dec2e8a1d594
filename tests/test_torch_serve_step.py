"""The input shapes and the inference steps by shape: ``configs.base.SHAPES``
/ ``shape_skips`` and ``transformer.init_cache_specs`` against the
reference's for every arch x shape, and the prefill and serve steps of
``distributed.stepfn`` (``make_step_for_shape``) on gloo against the
reference's ``make_prefill_step`` / ``make_serve_step`` on the same
``(data, model)`` mesh of host devices.

Each port mesh is one ``hvd.run_ranks`` launch (``python -c`` ranks on a
``file://`` store); the reference runs every case in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the pattern of
``tests/test_torch_sharded_step.py``).  Both run in f32 from the
reference's initial params (bridged, then cut into this rank's shards)
and the same numpy batch: tokens, positions and a random cache (bf16 K/V,
int8 codes and scales, f32 mamba state).  The serve step runs twice (at
each row's position, then the next), the prefill step once.  The cases
and the cache layout each exercises:

- ``heads-2x2``: qwen2 smoke under ``fsdp_tp``, 2 KV heads over model 2
  (layout (a): heads over ``model``), the batch over data 2, a
  vocabulary of 308 (split over model: the logits' all_gather);
- ``seq-1x4`` and ``seq-int8-1x4``: the same at (1, 4), where 2 KV heads
  do not divide 4: the sequence over ``model`` (layout (b)), the query
  heads gathered, bf16 and int8 caches (the int8 kernel's plain version
  with its log-sum-exp; the scales stay whole along the sequence, as the
  reference's specs give them);
- ``seq-dm-2x2-b1``: deepseek smoke with one KV head and a window of 4,
  B = 1 under ``long_500k``'s long-context variant: the sequence over
  ``(data, model)``, the window crossing two slices;
- ``moe-1x2``: qwen3-moe smoke, experts over model 2;
- ``mamba-1x2``: mamba2 smoke, its state split by head over model 2.

Checks: every rank's logits rows against the reference's within rtol and
atol 1e-5; the cache gathered from the shards (``sharding.unshard``)
against the reference's new cache: the mamba state (f32, rewritten
whole from the step's f32 products) within rtol 1e-5 and atol 1e-6, an
attention leaf bitwise except at the positions the steps wrote, which
hold f32 activations rounded to the cache's type and so may sit one unit
of its last place apart (one bf16 ulp, one int8 code) where an f32
difference of ~1e-7 upstream moves a rounding; and on the (2, 2) meshes each
rank's collective calls and bytes, group by group, equal the dry-run's
abstract count of the same step exactly (``launch.dryrun.count_step``).
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

from repro_torch.core import hvd

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
CACHE_TOL = 1e-6
S_PREFILL, S_CACHE = 16, 32
CASES = {
    "heads-2x2": dict(arch="qwen2-0.5b", over={"vocab_size": 308},
                      mesh=[2, 2], strategy="fsdp_tp", B=4,
                      pos=[3, 9, 30, 17]),
    "seq-1x4": dict(arch="qwen2-0.5b", over={"vocab_size": 308},
                    mesh=[1, 4], strategy="dp_tp", B=4, pos=[3, 9, 30, 15]),
    "seq-int8-1x4": dict(arch="qwen2-0.5b",
                         over={"vocab_size": 308, "kv_cache_dtype": "int8"},
                         mesh=[1, 4], strategy="dp_tp", B=4,
                         pos=[3, 9, 30, 15]),
    "seq-dm-2x2-b1": dict(arch="deepseek-coder-33b",
                          over={"vocab_size": 308, "num_kv_heads": 1,
                                "long_context_window": 4},
                          mesh=[2, 2], strategy="dp_tp", B=1, pos=[22],
                          long=True),
    "moe-1x2": dict(arch="qwen3-moe-30b-a3b", over={}, mesh=[1, 2],
                    strategy="dp_tp", B=4, pos=[3, 9, 30, 15]),
    "mamba-1x2": dict(arch="mamba2-1.3b", over={}, mesh=[1, 2],
                      strategy="dp_tp", B=4, pos=[3, 9, 30, 15]),
}


def _shapes(case):
    dec = "long_500k" if case.get("long") else "decode_32k"
    return {"prefill": ["prefill_32k", S_PREFILL, case["B"], "prefill"],
            "decode": [dec, S_CACHE, case["B"], "decode"]}


# ---------------------------------------------------------------------------
# shapes, skips, cache specs
# ---------------------------------------------------------------------------

def test_shapes_and_skips_match_reference():
    from repro.configs import ARCHS, get_config
    from repro.configs.base import SHAPES as RS, shape_skips as rskip
    from repro_torch.configs import get_config as pget
    from repro_torch.configs.base import SHAPES, shape_skips
    assert list(SHAPES) == list(RS)
    for name, s in SHAPES.items():
        r = RS[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            r.name, r.seq_len, r.global_batch, r.kind)
    skips = []
    for arch in ARCHS:
        for name in SHAPES:
            got = shape_skips(pget(arch), SHAPES[name])
            assert got == rskip(get_config(arch), RS[name]), (arch, name)
            skips += [(arch, name)] if got else []
    assert skips == [("whisper-small", "long_500k")]


def test_init_cache_specs_match_reference():
    from repro.configs import ARCHS, get_config
    from repro.models import transformer as RT
    from repro_torch.configs import get_config as pget
    from repro_torch.configs.base import SHAPES
    from repro_torch.models import transformer as T

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out
    for arch in ARCHS:
        for shape in SHAPES.values():
            for kv in ("bfloat16", "int8"):
                rc = get_config(arch).with_(kv_cache_dtype=kv)
                pc = pget(arch).with_(kv_cache_dtype=kv)
                want = flat(RT.init_cache_specs(rc, shape.global_batch,
                                                shape.seq_len))
                got = flat(T.init_cache_specs(pc, shape.global_batch,
                                              shape.seq_len))
                assert got.keys() == want.keys(), arch
                for k, t in got.items():
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == tuple(want[k].shape), (arch, k)
                    assert str(t.dtype).split(".")[-1] == str(
                        want[k].dtype), (arch, k)


def test_engine_serve_step_is_decode_step():
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape, synthesize_inputs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import make_serve_step
    cfg = get_smoke_config("qwen2-0.5b").with_(long_context_window=4)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = synthesize_inputs(cfg, InputShape("d", 16, 2, "decode"))
    batch["positions"] = torch.tensor([9, 14], dtype=torch.int32)
    for lc in (False, True):
        b1 = dict(batch, cache=T.init_cache(cfg, 2, 16))
        b2 = dict(batch, cache=T.init_cache(cfg, 2, 16))
        got, c1 = make_serve_step(cfg, long_context=lc)(params, b1)
        want, c2 = T.decode_step(params, cfg, b2, long_context=lc)
        assert torch.equal(got, want)
        assert torch.equal(c1["layers"]["k"], c2["layers"]["k"])


# ---------------------------------------------------------------------------
# sharded prefill and serve steps against the reference
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.checkpoint.ckpt import _flatten_with_paths
    from repro.configs import get_smoke_config
    from repro.configs.base import InputShape
    from repro.distributed import stepfn
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as T
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    flat = lambda t: {k: np.asarray(v, np.float32) if v.dtype != jnp.int8
                      else np.asarray(v) for k, v in
                      _flatten_with_paths(t).items()}
    for label, case in spec["cases"].items():
        cfg = get_smoke_config(case["arch"]).with_(dtype="float32",
                                                   **case["over"])
        params = jax.jit(T.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        np.savez(os.path.join(out, f"init-{label}.npz"), **flat(params))
        rng = np.random.default_rng(7)
        mesh = make_mesh(tuple(case["mesh"]), ("data", "model"))
        res = {}
        # prefill
        sn, S, B, kind = spec["shapes"][label]["prefill"]
        shape = InputShape(sn, S, B, kind)
        toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        step, _, _ = stepfn.make_prefill_step(cfg, mesh, case["strategy"],
                                              shape)
        res["prefill"] = np.asarray(step(params, {"tokens": toks}))
        np.save(os.path.join(out, f"ptok-{label}.npy"), toks)
        # serve: a random cache, two steps
        sn, S, B, kind = spec["shapes"][label]["decode"]
        shape = InputShape(sn, S, B, kind)
        def fill(path, a):
            if a.dtype == jnp.int8:
                return jnp.asarray(rng.integers(-127, 128, a.shape,
                                                dtype=np.int8))
            if "scale" in str(path[-1]):
                return jnp.asarray(rng.uniform(0.001, 0.02, a.shape),
                                   a.dtype)
            return jnp.asarray(0.3 * rng.standard_normal(a.shape), a.dtype)
        cache = jax.tree_util.tree_map_with_path(fill,
                                                 T.init_cache(cfg, B, S))
        np.savez(os.path.join(out, f"cache0-{label}.npz"), **flat(cache))
        step, _, _ = stepfn.make_serve_step(
            cfg, mesh, case["strategy"], shape,
            long_context=sn == "long_500k")
        pos = np.asarray(case["pos"], np.int32)
        for i in range(2):
            toks = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
            np.save(os.path.join(out, f"stok{i}-{label}.npy"), toks)
            logits, cache = step(params, {"tokens": toks,
                                          "positions": pos + i,
                                          "cache": cache})
            res[f"serve{i}"] = np.asarray(logits)
        np.savez(os.path.join(out, f"cache-{label}.npz"), **flat(cache))
        np.savez(os.path.join(out, f"ref-{label}.npz"), **res)
""")

PORT = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.core import hvd
from repro_torch.distributed import sharding as sh, stepfn
from repro_torch.launch.mesh import make_mesh
store, out, ref_dir = sys.argv[1], sys.argv[2], sys.argv[3]
spec = json.loads(sys.argv[4])
rank = int(os.environ["RANK"])
res = {}


def counts(groups):
    return {"/".join(k): list(v) for k, v in groups.counts().items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v.numpy() if v.dtype == torch.int8 else \
                v.float().numpy()
    return out


with hvd.init("cpu", init_method=store):
    for label, case in spec["cases"].items():
        cfg = get_smoke_config(case["arch"]).with_(dtype="float32",
                                                   **case["over"])
        groups = make_mesh(tuple(case["mesh"]), ("data", "model"))
        init = np.load(os.path.join(ref_dir, f"init-{label}.npz"))
        full = bridge.from_flat({k: init[k] for k in init.files},
                                weight_dtype=torch.float32)
        strategy = case["strategy"]
        pspec = sh.params_pspec(stepfn.params_struct(cfg), cfg, strategy,
                                groups)
        params = sh.shard(full, pspec, groups)
        got = {"counts": {}}
        sn, S, B, kind = spec["shapes"][label]["prefill"]
        step, structs = stepfn.make_step_for_shape(
            cfg, groups, strategy, InputShape(sn, S, B, kind), device="cpu")
        toks = np.load(os.path.join(ref_dir, f"ptok-{label}.npy"))
        groups.reset_counts()
        logits = step(params, sh.shard({"tokens": torch.from_numpy(toks)},
                                       structs["specs"]["batch"], groups))
        got["counts"]["prefill"] = counts(groups)
        got["prefill"] = logits.numpy().tolist()
        sn, S, B, kind = spec["shapes"][label]["decode"]
        step, structs = stepfn.make_step_for_shape(
            cfg, groups, strategy, InputShape(sn, S, B, kind), device="cpu")
        bspec = structs["specs"]["batch"]
        c0 = np.load(os.path.join(ref_dir, f"cache0-{label}.npz"))
        from repro_torch.models import transformer as T
        like = T.init_cache(cfg, B, S)

        def load(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: load(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in tree.items()}
            return torch.from_numpy(c0[prefix]).to(tree.dtype)
        cache = load(like)
        pos = torch.tensor(case["pos"], dtype=torch.int32)
        local = sh.shard({"tokens": torch.zeros((B, 1), dtype=torch.int32),
                          "positions": pos, "cache": cache}, bspec, groups)
        lcache = local["cache"]
        for i in range(2):
            toks = torch.from_numpy(np.load(os.path.join(
                ref_dir, f"stok{i}-{label}.npy")))
            b = sh.shard({"tokens": toks, "positions": pos + i,
                          "cache": {}}, bspec, groups)
            b["cache"] = lcache
            groups.reset_counts()
            logits, lcache = step(params, b)
            got["counts"][f"serve{i}"] = counts(groups)
            got[f"serve{i}"] = logits.numpy().tolist()
        whole = sh.unshard(lcache, bspec["cache"], groups)
        if rank == 0:
            np.savez(os.path.join(out, f"port-cache-{label}.npz"),
                     **flat(whole))
        res[label] = got
json.dump(res, open(os.path.join(out, f"rank{rank}.json"), "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference")
    spec = {"cases": CASES, "shapes": {k: _shapes(c)
                                       for k, c in CASES.items()}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                        json.dumps(spec)], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return out


def _rows(case, rank):
    """The global rows rank ``rank`` holds (the batch splits over data
    where it divides)."""
    D, M = case["mesh"]
    B = case["B"]
    if B % D or B < D:
        return slice(0, B)
    d = rank // M
    return slice(d * B // D, (d + 1) * B // D)


def _run(world, labels, reference, tmp_path):
    cases = {k: CASES[k] for k in labels}
    spec = {"cases": cases, "shapes": {k: _shapes(c) for k, c in
                                       cases.items()}}
    hvd.run_ranks(PORT, world, tmp_path, str(reference), json.dumps(spec),
                  timeout=400)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


def _check(label, runs, reference, tmp_path):
    case = CASES[label]
    ref = np.load(reference / f"ref-{label}.npz")
    for r, run in enumerate(runs):
        got = run[label]
        rows = _rows(case, r)
        for key in ("prefill", "serve0", "serve1"):
            np.testing.assert_allclose(np.asarray(got[key]),
                                       ref[key][rows], rtol=TOL, atol=TOL,
                                       err_msg=f"{label} {key} rank {r}")
    want = np.load(reference / f"cache-{label}.npz")
    have = np.load(tmp_path / f"port-cache-{label}.npz")
    assert sorted(have.files) == sorted(want.files)
    for k in want.files:
        h, w = have[k].astype(np.float32), want[k].astype(np.float32)
        if k.endswith(("ssm", "conv")):          # f32 state, all rewritten
            np.testing.assert_allclose(h, w, rtol=TOL, atol=CACHE_TOL,
                                       err_msg=f"{label} {k}")
            continue
        # attention leaves: the positions the two steps wrote hold f32
        # activations rounded to the cache's type (one ulp: bf16 at most
        # 2^-7 relative, one int8 code), every other element is untouched
        ax = h.ndim - (3 if k.endswith(("/k", "/v")) else 2)
        written = np.zeros(h.shape, bool)
        for b, p in enumerate(case["pos"]):
            for i in range(2):
                idx = [slice(None)] * h.ndim
                idx[ax - 1], idx[ax] = b, p + i
                written[tuple(idx)] = True
        np.testing.assert_array_equal(h[~written], w[~written],
                                      err_msg=f"{label} {k}")
        ulp = (np.ones_like(w) if have[k].dtype == np.int8
               else 2.0 ** -7 * np.abs(w))       # a bf16 ulp, at most
        assert np.all((np.abs(h - w) <= np.maximum(ulp, CACHE_TOL))[
            written]), (label, k)


def _check_counts(label, runs):
    """Each rank's collectives (calls, bytes by group) equal the dry-run's
    abstract count of the same step on that rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import count_step
    case = CASES[label]
    cfg = get_smoke_config(case["arch"]).with_(dtype="float32",
                                               **case["over"])
    mesh = dict(zip(("data", "model"), case["mesh"]))
    for r, run in enumerate(runs):
        for kind, key in (("prefill", "prefill"), ("decode", "serve0")):
            shape = InputShape(*_shapes(case)[kind])
            want = count_step(cfg, shape, case["strategy"], mesh,
                              rank=r)["groups_counts"]
            assert run[label]["counts"][key] == want, (label, key, r)


def test_sharded_steps_at_world_size_4(reference, tmp_path):
    labels = ["heads-2x2", "seq-1x4", "seq-int8-1x4", "seq-dm-2x2-b1"]
    runs = _run(4, labels, reference, tmp_path)
    for label in labels:
        _check(label, runs, reference, tmp_path)
    for label in ("heads-2x2", "seq-dm-2x2-b1"):
        _check_counts(label, runs)


def test_sharded_steps_at_world_size_2(reference, tmp_path):
    labels = ["moe-1x2", "mamba-1x2"]
    runs = _run(2, labels, reference, tmp_path)
    for label in labels:
        _check(label, runs, reference, tmp_path)


# ---------------------------------------------------------------------------
# on the card: the int8 kernel's log-sum-exp and the sequence-split decode
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (q_start, kv_len) rows of one int8 call over a 4,096-position slice, as
# ``attention._split_decode`` rebases them: no valid key (a slice after
# the query), q_start past the slice (a slice before it), the query in
# the slice at its start, middle and end, and a row whose window ends
# before the slice (no valid key when the window is 2,048)
INT8_ROWS = [(0, 0), (4101, 4096), (7200, 4096), (0, 1), (700, 701),
             (2500, 2501), (4095, 4096), (100, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 2048])
def test_cuda_int8_lse_matches_plain(cuda, dtype, window):
    """``flash_attention_int8kv(..., return_lse=True)`` on the card (the
    row log-sum-exp rebuilt from the split kernel's (m, l) partials)
    against ``attention_int8kv_ref(..., return_lse=True)`` over a split
    plan of several splits: the output at ``chip_smoke.py``'s int8
    tolerances, each finite lse within f32 rounding (rtol and atol 1e-5),
    and the rows with no valid key -inf exactly, with zero output."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_int8kv_ref
    from repro_torch.models.attention import quantize_kv
    dt = getattr(torch, dtype)
    B, Skv, H, KV, D = len(INT8_ROWS), 4096, 14, 2, 64
    g = torch.Generator().manual_seed(26)
    q = torch.randn((B, 1, H, D), generator=g).to(dt).to(cuda)
    k8, ks = quantize_kv(torch.randn((B, Skv, KV, D), generator=g))
    v8, vs = quantize_kv(torch.randn((B, Skv, KV, D), generator=g))
    ks, vs = ks.to(dt), vs.to(dt)
    qs = torch.tensor([a for a, _ in INT8_ROWS], dtype=torch.int32)
    n = torch.tensor([b for _, b in INT8_ROWS], dtype=torch.int32)
    args = [t.to(cuda) for t in (q, k8, ks, v8, vs, qs, n)]
    _, splits = fa.int8_split_plan(B, KV, Skv, D, H // KV,
                                   fa.device_sm_count(q.device))
    assert splits > 1
    launches = fa.flash_attention_int8kv.launches
    out, lse = fa.flash_attention_int8kv(*args, window=window,
                                         return_lse=True)
    assert fa.flash_attention_int8kv.launches == launches + 1
    ref, ref_lse = attention_int8kv_ref(*args, window=window,
                                        return_lse=True)
    assert lse.shape == ref_lse.shape == (B, 1, H)
    dead = torch.isinf(ref_lse)
    assert dead.any() and (window is None or dead[2].all())
    assert torch.equal(torch.isneginf(lse), dead)
    torch.testing.assert_close(lse[~dead], ref_lse[~dead], rtol=1e-5,
                               atol=1e-5)
    assert not out[dead.any(dim=-1)].any()
    err = (out.float() - ref.float()).abs()
    if dt == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        assert (err / ref.float().abs().clamp(min=2.0 ** -4)).max().item() \
            <= 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 64])
def test_cuda_split_decode_at_one_rank_is_dense_decode(cuda, int8, window):
    """``attention._split_decode`` with the whole sequence on a group of
    one (an NCCL group of world size 1) against ``_dense_decode`` on the
    same cache and step: the caches written alike, bit for bit, and the
    outputs equal, bit for bit through the int8 kernel (its lse gives a
    merge weight of exactly 1) and within one bf16 ulp through the bf16
    cache's plain attention (f32 sums in another order)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as A
    B, S, H, KV, D = 4, 512, 14, 2, 64
    g = torch.Generator().manual_seed(27)
    r = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16).to(cuda)
    if int8:
        k8, ks = A.quantize_kv(torch.randn((B, S, KV, D), generator=g))
        v8, vs = A.quantize_kv(torch.randn((B, S, KV, D), generator=g))
        cache = {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    else:
        cache = {"k": r(B, S, KV, D), "v": r(B, S, KV, D)}
    cache = {name: t.to(cuda) for name, t in cache.items()}
    q, k, v = r(B, 1, H, D), r(B, 1, KV, D), r(B, 1, KV, D)
    idx = torch.tensor([0, 63, 300, 511], device=cuda)
    kw = dict(scale=D ** -0.5, window=window, softcap=None)
    with hvd.init("cuda"):
        model = make_host_mesh()["model"]
        assert model.size == 1
        split = {name: t.clone() for name, t in cache.items()}
        got = A._split_decode(split, {name: (model, 0) for name in split},
                              q, k, v, idx, **kw)
    dense = {name: t.clone() for name, t in cache.items()}
    want = A._dense_decode(dense, q, k, v, idx, q_chunk=0, **kw)
    assert all(torch.equal(split[name], dense[name]) for name in cache)
    assert got.shape == want.shape and got.dtype == want.dtype
    if int8:
        assert torch.equal(got, want)
    else:
        err = (got.float() - want.float()).abs()
        assert (err / want.float().abs().clamp(min=2.0 ** -4)).max().item() \
            <= 2.0 ** -7
