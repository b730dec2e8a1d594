"""The sharding rules of ``repro_torch.distributed.sharding`` against the
reference's ``repro.distributed.sharding``, and the mesh of
``repro_torch.launch.mesh``.

- For all ten architectures at full width (shapes only: the port's
  ``init_params`` on the ``meta`` device against the reference's
  ``jax.eval_shape``), the parameter, AdamW-state and batch specs (every
  input shape of the reference's ``SHAPES``, caches included) equal the
  reference's leaf for leaf, as tuples, under each strategy, on the
  production meshes (16, 16) and (2, 16, 16) and on (2, 2).  No device is
  needed: a mesh is its axis sizes.
- The reference's own cases (``tests/test_distributed.py``): ``fit_spec``
  drops, Megatron's rules, indivisible heads, expert parallelism, the
  decode cache layouts.
- ``local_bytes`` summed over a mesh's ranks equals the full tree's bytes
  times each leaf's replication, exactly.
- The H100 figures of ``launch.mesh`` and its production layouts.
- The autograd collectives of ``core/hvd.py`` at 2 gloo ranks: forward
  values and the gradients their backwards hand each rank, exactly, and
  the bytes each kind counts.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import optim as jopt
from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES, input_specs as ref_input_specs
from repro.distributed import sharding as rsh
from repro.distributed import stepfn as rstep
from repro_torch import optim as popt
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, input_specs
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import stepfn
from repro_torch.launch import mesh as pmesh

torch.set_num_threads(2)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {rsh._path_str(p): tuple(s) for p, s in flat}


def _port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_port_flat(v, path))
        else:
            out[path] = v
    return out


@pytest.fixture(scope="module", params=ARCHS)
def structs(request):
    arch = request.param
    rcfg, pcfg = ref_config(arch), get_config(arch)
    rparams = rstep.params_struct(rcfg)
    ropt = jax.eval_shape(jopt.adamw(1e-4).init, rparams)
    pparams = stepfn.params_struct(pcfg)
    popt_state = popt.adamw(1e-4).init(pparams)
    return arch, rcfg, pcfg, rparams, ropt, pparams, popt_state


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_specs_equal_the_reference(structs, mesh_name):
    arch, rcfg, pcfg, rparams, ropt, pparams, popt_state = structs
    mesh = pmesh.AbstractMesh(*MESHES[mesh_name])
    # the shapes themselves: the meta tree is the reference's, leaf for leaf
    rshapes = {rsh._path_str(p): tuple(l.shape) for p, l in
               jax.tree_util.tree_flatten_with_path(rparams)[0]}
    assert {k: tuple(v.shape) for k, v in _port_flat(pparams).items()} \
        == rshapes
    for strategy in sh.STRATEGIES:
        rspec = rsh.params_pspec(rparams, rcfg, strategy, mesh)
        pspec = sh.params_pspec(pparams, pcfg, strategy, mesh)
        assert _port_flat(pspec) == _ref_flat(rspec), (arch, strategy)
        assert _port_flat(sh.opt_state_pspec(popt_state, pspec)) == \
            _ref_flat(rsh.opt_state_pspec(ropt, rspec)), (arch, strategy)
        for sname, rshape in SHAPES.items():
            pshape = InputShape(rshape.name, rshape.seq_len,
                                rshape.global_batch, rshape.kind)
            want = _ref_flat(rsh.batch_pspec(
                ref_input_specs(rcfg, rshape), mesh, rcfg, rshape, strategy))
            got = _port_flat(sh.batch_pspec(input_specs(pcfg, pshape), mesh,
                                            pcfg, pshape, strategy))
            assert got == want, (arch, strategy, sname)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_distributed.py)
# ---------------------------------------------------------------------------

MESH = pmesh.production_mesh()


def test_fit_spec_drops_indivisible_axes():
    assert sh.fit_spec((None, "model", None), (24, 2, 64), MESH) == \
        (None, None, None)
    assert sh.fit_spec(("data", "model"), (32, 32), MESH) == \
        ("data", "model")
    assert sh.fit_spec((("data", "model"), None), (256, 4), MESH)[0] == \
        ("data", "model")
    assert sh.fit_spec((("data", "model"), None), (16, 4), MESH)[0] == \
        "data"


def test_param_specs_megatron_rules():
    cfg = get_config("qwen2-vl-72b")           # 64 heads: divisible by 16
    assert sh.param_spec("layers/attn/wq/w", (80, 1, 8192, 64, 128), cfg,
                         "fsdp_tp", MESH) == (None, None, "data", "model",
                                              None)
    assert sh.param_spec("layers/attn/wo/w", (80, 1, 8192, 8192), cfg,
                         "fsdp_tp", MESH) == (None, None, "model", "data")
    assert sh.param_spec("layers/mlp/wi/w", (80, 1, 8192, 29568), cfg,
                         "fsdp_tp", MESH) == (None, None, "data", "model")
    assert sh.param_spec("layers/mlp/wi/w", (80, 1, 8192, 29568), cfg,
                         "dp_tp", MESH) == (None, None, None, "model")
    assert sh.param_spec("layers/mlp/wi/w", (80, 1, 8192, 29568), cfg, "dp",
                         MESH) == ()


def test_param_specs_indivisible_heads_fall_back():
    """deepseek-coder has 56 heads (not divisible by 16): attention weights
    drop 'model'; the MLP stays tensor-parallel."""
    cfg = get_config("deepseek-coder-33b")
    assert sh.param_spec("layers/attn/wq/w", (62, 1, 7168, 56, 128), cfg,
                         "fsdp_tp", MESH) == (None, None, "data", None, None)
    assert sh.param_spec("layers/mlp/wi/w", (62, 1, 7168, 19200), cfg,
                         "fsdp_tp", MESH) == (None, None, "data", "model")


def test_moe_expert_parallel_spec():
    cfg = get_config("dbrx-132b")
    assert sh.param_spec("layers/moe/wi", (40, 1, 16, 6144, 10752), cfg,
                         "fsdp_tp", MESH) == (None, None, "model", "data",
                                              None)
    assert sh.param_spec("layers/moe/wo", (40, 1, 16, 10752, 6144), cfg,
                         "fsdp_tp", MESH) == (None, None, "model", None,
                                              "data")


def test_batch_pspec_decode_cache_layouts():
    shape = SHAPES["decode_32k"]
    pshape = InputShape(shape.name, shape.seq_len, shape.global_batch,
                        shape.kind)
    cfg = get_config("dbrx-132b")                   # kv 8: seq-sharded
    kspec = sh.batch_pspec(input_specs(cfg, pshape), MESH, cfg,
                           pshape)["cache"]["layers"]["k"]
    assert kspec[-3] == "model" and kspec[-2] is None, kspec
    cfg2 = get_config("gemma2-27b")                 # kv 16: head-sharded
    kspec2 = sh.batch_pspec(input_specs(cfg2, pshape), MESH, cfg2,
                            pshape)["cache"]["layers"]["k"]
    assert kspec2[-2] == "model"


def test_invalid_strategy_is_refused():
    with pytest.raises(ValueError, match="strategy"):
        sh.param_spec("embed/table", (8, 4), get_config("qwen2-0.5b"),
                      "zero3", MESH)


# ---------------------------------------------------------------------------
# local bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-27b", "qwen3-moe-30b-a3b",
                                  "mamba2-1.3b"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_local_bytes_times_ranks_is_the_replicated_total(arch, mesh_name):
    """A rank's bytes (every rank holds as many) times the ranks equal each
    leaf's bytes times its replication, summed, exactly; ``dp`` holds the
    whole tree on every rank."""
    cfg = get_config(arch)
    mesh = pmesh.AbstractMesh(*MESHES[mesh_name])
    params = stepfn.params_struct(cfg)
    full = sum(t.numel() * t.element_size()
               for t in _port_flat(params).values())
    for strategy in sh.STRATEGIES:
        specs = sh.params_pspec(params, cfg, strategy, mesh)
        local = sh.local_bytes(specs, params, mesh.shape)
        flat_p, flat_s = _port_flat(params), _port_flat(specs)
        replicated = sum(flat_p[k].numel() * flat_p[k].element_size()
                         * sh.replication(flat_s[k], mesh.shape)
                         for k in flat_p)
        assert local * mesh.size == replicated, (strategy, mesh_name)
        if strategy == "dp":
            assert local == full
        else:
            assert local < full


def test_production_meshes_and_card_figures():
    assert pmesh.production_mesh().shape == {"data": 16, "model": 16}
    multi = pmesh.production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert sh.data_axes(multi) == ("pod", "data")
    assert pmesh.H100_SXM_PEAK_FLOPS_BF16 == 989e12
    assert pmesh.H100_SXM_HBM_BW == 3.35e12
    assert not hasattr(pmesh, "PEAK_FLOPS_BF16")


# ---------------------------------------------------------------------------
# the collectives inside a model (gloo, 2 ranks)
# ---------------------------------------------------------------------------

COLLECTIVES = """
import os, sys
import numpy as np
import torch
from repro_torch.core import hvd
store, out = sys.argv[1], sys.argv[2]
with hvd.init("cpu", init_method=store):
    g = hvd.axis_groups({"model": 2})["model"]
    r = g.rank
    x = (torch.arange(12.0).reshape(3, 4) + 100 * r).requires_grad_(True)
    w = torch.arange(24.0).reshape(6, 4) / 7 + r
    res = {}
    for name, fn, wshape in (
            ("all_gather_dim", lambda t: hvd.all_gather_dim(t, 1, g), (3, 8)),
            ("reduce_scatter_dim",
             lambda t: hvd.reduce_scatter_dim(t, 1, g), (3, 2)),
            ("copy_to_group", lambda t: hvd.copy_to_group(t, g), (3, 4)),
            ("reduce_from_group", lambda t: hvd.reduce_from_group(t, g),
             (3, 4)),
            ("scatter_to_group", lambda t: hvd.scatter_to_group(t, 1, g),
             (3, 2)),
            ("gather_from_group", lambda t: hvd.gather_from_group(t, 0, g),
             (6, 4)),
            ("mean_over_group", lambda t: hvd.mean_over_group(t, g),
             (3, 4))):
        y = fn(x)
        dy = w.reshape(-1)[:y.numel()].reshape(wshape)
        (gx,) = torch.autograd.grad(y, x, dy)
        res[name] = y.detach().numpy()
        res[name + "/grad"] = gx.numpy()
    res["max"] = hvd.all_reduce_max(x.detach() * (1 - 2 * r), g).numpy()
    kinds = {k: v for k, v in g.kinds.items()}
np.savez(os.path.join(out, f"c{r}.npz"), **res,
         kinds=np.array(sorted((k, *v) for k, v in kinds.items())))
"""


def test_model_collectives_and_their_gradients(tmp_path):
    """Each autograd collective of ``core/hvd.py`` at 2 gloo ranks: its
    forward and the gradient its backward hands each rank, against
    numpy, exactly (small integers and sevenths in f32); and what each
    rank handed each kind."""
    from repro_torch.core import hvd
    hvd.run_ranks(COLLECTIVES, 2, tmp_path)
    got = [dict(np.load(tmp_path / f"c{r}.npz")) for r in range(2)]
    x = [np.arange(12.0).reshape(3, 4) + 100 * r for r in range(2)]
    w = [np.arange(24.0).reshape(6, 4) / 7 + r for r in range(2)]

    def dy(r, shape):
        return w[r].reshape(-1)[:int(np.prod(shape))].reshape(shape)
    for r in range(2):
        o = got[r]
        np.testing.assert_array_equal(
            o["all_gather_dim"], np.concatenate(x, axis=1))
        # backward: the sum over ranks of this rank's columns
        np.testing.assert_allclose(
            o["all_gather_dim/grad"],
            sum(dy(s, (3, 8)) for s in range(2))[:, 4 * r:4 * r + 4],
            rtol=1e-6)
        np.testing.assert_array_equal(
            o["reduce_scatter_dim"], (x[0] + x[1])[:, 2 * r:2 * r + 2])
        np.testing.assert_allclose(
            o["reduce_scatter_dim/grad"],
            np.concatenate([dy(s, (3, 2)) for s in range(2)], axis=1),
            rtol=1e-6)
        np.testing.assert_array_equal(o["copy_to_group"], x[r])
        np.testing.assert_allclose(o["copy_to_group/grad"],
                                   dy(0, (3, 4)) + dy(1, (3, 4)), rtol=1e-6)
        np.testing.assert_array_equal(o["reduce_from_group"], x[0] + x[1])
        np.testing.assert_allclose(o["reduce_from_group/grad"],
                                   dy(r, (3, 4)), rtol=1e-6)
        np.testing.assert_array_equal(o["scatter_to_group"],
                                      x[r][:, 2 * r:2 * r + 2])
        want = np.concatenate([dy(s, (3, 2)) for s in range(2)], axis=1)
        np.testing.assert_allclose(o["scatter_to_group/grad"], want,
                                   rtol=1e-6)
        np.testing.assert_array_equal(o["gather_from_group"],
                                      np.concatenate(x, axis=0))
        np.testing.assert_allclose(o["gather_from_group/grad"],
                                   dy(r, (6, 4))[3 * r:3 * r + 3],
                                   rtol=1e-6)
        np.testing.assert_allclose(o["mean_over_group"], (x[0] + x[1]) / 2)
        np.testing.assert_allclose(o["mean_over_group/grad"],
                                   (dy(0, (3, 4)) + dy(1, (3, 4))) / 2,
                                   rtol=1e-6)
        np.testing.assert_array_equal(o["max"], np.maximum(x[0], -x[1]))
    kinds = {str(k[0]): (int(k[1]), int(k[2])) for k in got[0]["kinds"]}
    # 48-byte (3, 4) f32 tensors: all_gather hands its shard (fwd) and the
    # scatter's and gather's backward theirs; reduce_scatter the whole
    assert kinds == {"all_gather": (4, 48 + 24 + 24 + 48),
                     "reduce_scatter": (2, 48 + 96),
                     "all_reduce": (5, 48 * 5)}
