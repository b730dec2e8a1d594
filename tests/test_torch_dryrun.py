"""The dry-run as meta-device accounting (``repro_torch.launch.dryrun``).

On the CPU, with no device and no process group: the reference test's
pairs (``tests/test_dryrun.py``) at the (16, 16) production layout, the
multi-pod layout, whisper's skipped ``long_500k``; ``argument_size``
against ``sharding.local_bytes`` of the specs; the prefill and serve
FLOPs of qwen2-0.5b and deepseek-coder-33b at (1, 1) against a closed
formula from the config; the counts' affinity in the layer groups
(``roofline_pair``'s ``groups``); an abstract group refusing a CPU
tensor; and the train step's collectives at (2, 2) on gloo against the
abstract count, rank by rank (the prefill and serve steps' are in
``tests/test_torch_serve_step.py``).

On the card (``gpu``, skipped here): each kernel wrapper's ``meta`` route
against its CUDA route at one shape: the same output shapes and dtypes,
and the bytes the meta route allocates (rounded up as the caching
allocator rounds each block, to 512 bytes) equal to the CUDA route's peak
allocation over the call.
"""
import json
import weakref

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, InputShape, input_specs
from repro_torch.core import hvd
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import stepfn
from repro_torch.launch import dryrun

torch.set_num_threads(2)

PAIRS = [
    ("qwen2-0.5b", "train_4k"),        # dense train
    ("dbrx-132b", "decode_32k"),       # MoE decode, seq-sharded cache
    ("mamba2-1.3b", "long_500k"),      # SSM long-context decode
    ("whisper-small", "prefill_32k"),  # enc-dec prefill
]


def _argument_bytes(arch, shape_name, multi_pod=False):
    """``sharding.local_bytes`` of the params (and AdamW state) and the
    batch by their specs on the production layout."""
    from repro_torch import optim
    from repro_torch.configs import default_strategy
    from repro_torch.launch.mesh import production_mesh
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = production_mesh(multi_pod=multi_pod)
    strategy = default_strategy(cfg)
    pstruct = stepfn.params_struct(cfg)
    pspec = sh.params_pspec(pstruct, cfg, strategy, mesh)
    bstruct = input_specs(cfg, shape)
    n = sh.local_bytes(pspec, pstruct, mesh.shape) + sh.local_bytes(
        sh.batch_pspec(bstruct, mesh, cfg, shape, strategy), bstruct,
        mesh.shape)
    if shape.kind == "train":
        ostruct = optim.adamw(1e-4).init(pstruct)
        n += sh.local_bytes(sh.opt_state_pspec(ostruct, pspec), ostruct,
                            mesh.shape)
    return n


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_dryrun_pair(arch, shape):
    rec = dryrun.dryrun_pair(arch, shape, verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["argument_size"] == _argument_bytes(arch, shape)
    assert rec["peak_memory_per_device"] >= rec["argument_size"]
    assert rec["temp_size"] == rec["peak_memory_per_device"] \
        - rec["argument_size"]
    assert sum(rec["collective_bytes"].values()) \
        == rec["collective_bytes_total"] \
        == sum(rec["collective_bytes_by_scope"].values())
    assert rec["collective_bytes_by_scope"]["inter_pod"] == 0
    assert rec["fits"] == (rec["peak_memory_per_device"] <= 80 * 10**9)


def test_dryrun_multipod_and_skip(tmp_path):
    out = tmp_path / "rec.jsonl"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--multi-pod", "--json", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["argument_size"] == _argument_bytes("qwen2-0.5b",
                                                   "decode_32k", True)
    assert dryrun.main(["--arch", "whisper-small", "--shape", "long_500k",
                        "--json", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "skip"


def _closed_flops(cfg, kind, B, S):
    """FLOPs of a dense decoder's prefill (``forward(last_only=True)``)
    or serve step on one rank holding it whole: 2 per multiply-add of
    every projection, the flash kernel's 4 per (query head, attended key,
    dim) under the causal mask (prefill), the plain decode attention's 4
    per (query head, cache slot, dim) over every slot (serve: the bf16
    cache is attended through a mask, not skipped), and the RMSNorm
    kernel's 4 per element (two a layer and the final one over the last
    position)."""
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    T = B * S if kind == "prefill" else B
    layer = (2 * T * d * (h + 2 * kv) * dh + 2 * T * h * dh * d
             + 3 * 2 * T * d * cfg.d_ff + 2 * 4 * T * d)
    if kind == "prefill":
        layer += 4 * B * h * dh * S * (S + 1) // 2
    else:
        layer += 4 * B * h * dh * S
    return cfg.num_layers * layer + 4 * B * d + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-coder-33b"])
@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_inference_flops_equal_a_closed_formula(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    got = dryrun.count_step(cfg, shape, "dp_tp", {"data": 1, "model": 1})
    assert got["flops"] == _closed_flops(cfg, shape.kind,
                                         shape.global_batch, shape.seq_len)


@pytest.mark.parametrize("arch,shape_name", [("qwen2-0.5b", "decode_32k"),
                                             ("zamba2-1.2b", "prefill_32k"),
                                             ("gemma2-2b", "train_4k")])
def test_roofline_counts_are_affine_in_layer_groups(arch, shape_name):
    """The full-depth count at G groups is cost(1) + (G - 1)(cost(2) -
    cost(1)), exactly, for FLOPs, bytes and each kind of collective (the
    reference's extrapolation holds for the port's loop)."""
    cfg = get_config(arch)
    G, c1, c2 = dryrun._group_counts(cfg)
    full = dryrun.roofline_pair(arch, shape_name, verbose=False)
    assert full["groups"] == G
    one = dryrun.roofline_pair(arch, shape_name, cfg=c1, verbose=False)
    two = dryrun.roofline_pair(arch, shape_name, cfg=c2, verbose=False)
    for key in ("flops", "bytes_accessed", "collective_bytes_total"):
        assert full[key] == one[key] + (G - 1) * (two[key] - one[key]), key
    for k in full["collective_bytes"]:
        a, b = one["collective_bytes"][k], two["collective_bytes"][k]
        assert full["collective_bytes"][k] == a + (G - 1) * (b - a), k


def test_abstract_group_takes_meta_tensors_only():
    groups = hvd.abstract_groups({"data": 16, "model": 16}, rank=37)
    g = groups["model"]
    assert (g.size, g.rank, g.ranks[0]) == (16, 5, 32)
    assert groups[("data", "model")].ranks == list(range(256))
    out = hvd.gather_dim(torch.empty((2, 3), device="meta"), 1, g)
    assert out.shape == (2, 48) and out.device.type == "meta"
    assert g.kinds == {"all_gather": [1, 24]}
    with pytest.raises(ValueError, match="meta tensors only"):
        hvd.allreduce(torch.ones(4), g)
    with pytest.raises(ValueError, match="meta tensors only"):
        hvd.all_reduce_max(torch.ones(4), groups["data"])


TRAIN = """
import json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch import optim
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape, synthesize_inputs
from repro_torch.core import hvd
from repro_torch.distributed import sharding as sh, stepfn
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T
store, out = sys.argv[1], sys.argv[2]
spec = json.loads(sys.argv[3])
with hvd.init("cpu", init_method=store):
    groups = make_mesh(tuple(spec["mesh"]), ("data", "model"))
    cfg = get_smoke_config(spec["arch"]).with_(**spec["over"])
    shape = InputShape(*spec["shape"])
    step, structs = stepfn.make_step_for_shape(cfg, groups, spec["strategy"],
                                               shape, device="cpu")
    full = T.init_params(cfg, torch.Generator().manual_seed(0),
                         weight_dtype=torch.float32)
    params = sh.shard(full, structs["specs"]["params"], groups)
    opt_state = optim.adamw(1e-4).init(params)
    batch = sh.shard(synthesize_inputs(cfg, shape), structs["specs"]["batch"],
                     groups)
    groups.reset_counts()
    step(params, opt_state, batch)
    counts = {"/".join(k): list(v) for k, v in groups.counts().items()}
json.dump(counts, open(os.path.join(out, f"rank{os.environ['RANK']}.json"),
                       "w"))
"""


def test_train_step_collectives_equal_the_gloo_run(tmp_path):
    spec = {"arch": "qwen2-0.5b", "over": {"vocab_size": 308,
                                           "dtype": "float32"},
            "mesh": [2, 2], "strategy": "fsdp_tp",
            "shape": ["train_4k", 16, 4, "train"]}
    hvd.run_ranks(TRAIN, 4, tmp_path, json.dumps(spec))
    cfg = get_smoke_config(spec["arch"]).with_(**spec["over"])
    for r in range(4):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        want = dryrun.count_step(cfg, InputShape(*spec["shape"]),
                                 spec["strategy"], {"data": 2, "model": 2},
                                 rank=r)["groups_counts"]
        assert got == want, r


# ---------------------------------------------------------------------------
# on the card: the meta routes against the CUDA routes
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Blocks(dryrun.Accounting):
    """The meta route's peak of new storages, each rounded up to the
    caching allocator's 512-byte blocks."""

    def track(self, tree):
        for t in dryrun._tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self.live and st.nbytes():
                st_bytes = -(-st.nbytes() // 512) * 512
                self.live[st._cdata] = st_bytes
                self.live_bytes += st_bytes
                weakref.finalize(st, self._free, st._cdata)
        self.peak = max(self.peak, self.live_bytes)


def _kernel_calls():
    """(name, fn(device) -> output) of every wrapper at one shape each."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    g = torch.Generator().manual_seed(0)

    def r(*s, dt=torch.bfloat16):
        return torch.randn(s, generator=g).to(dt)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    q, k, v = r(2, 256, 14, 64), r(2, 256, 2, 64), r(2, 256, 2, 64)
    k8 = torch.randint(-127, 128, (2, 512, 2, 64), generator=g,
                       dtype=torch.int8)
    ks = torch.rand((2, 512, 2), generator=g).to(torch.bfloat16)
    pages = r(40, 16, 2, 64)
    tables = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    x, dt_, A = r(2, 512, 8, 64), torch.rand((2, 512, 8), generator=g), \
        -torch.rand(8, generator=g)
    Bm = r(2, 512, 1, 64)
    return {
        "flash_attention": ((q, k, v), lambda a: fa.flash_attention(*a)),
        "flash_attention_d_tail": (
            (r(1, 128, 4, 80), r(1, 128, 2, 80), r(1, 128, 2, 80)),
            lambda a: fa.flash_attention(*a)),
        "flash_attention_int8kv": (
            (r(2, 1, 14, 64), k8, ks, k8, ks, i32([300, 511]),
             i32([301, 512])),
            lambda a: fa.flash_attention_int8kv(*a)),
        "paged_attention": (
            (r(2, 2, 7, 64), pages, pages, tables, i32([100, 256])),
            lambda a: pa.paged_attention(*a)),
        "paged_prefill": (
            (r(2, 2, 16 * 7, 64), pages, pages, tables, i32([0, 100]),
             i32([16, 9])),
            lambda a: pp.paged_prefill(*a, group=7)),
        "ssd_scan": ((x, dt_, A, Bm, r(2, 512, 1, 64)),
                     lambda a: ssd.ssd_scan(*a, 256)),
        "rmsnorm": ((r(64, 896), torch.zeros(896)),
                    lambda a: rn.rmsnorm(*a, out_dtype=torch.bfloat16)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_d_tail",
                                  "flash_attention_int8kv",
                                  "paged_attention", "paged_prefill",
                                  "ssd_scan", "rmsnorm"])
def test_meta_route_matches_cuda_route(cuda, name):
    from repro_torch.kernels import _build
    args, fn = _kernel_calls()[name]
    on_card = [a.to(cuda) for a in args]
    fn(on_card)                                  # build, warm up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    launches = _build.launch_counts()
    out = fn(on_card)
    torch.cuda.synchronize()
    card_bytes = torch.cuda.max_memory_allocated(cuda) - base
    assert _build.launch_counts() != launches
    on_meta = [a.to("meta") for a in args]
    _build.meta_cost.reset()
    launches = _build.launch_counts()
    acct = _Blocks()
    with acct:
        acct.track(on_meta)
        base_meta = acct.live_bytes
        got = fn(on_meta)
    assert _build.launch_counts() == launches      # the meta route launches
    outs = out if isinstance(out, tuple) else (out,)
    gots = got if isinstance(got, tuple) else (got,)
    assert [(o.shape, o.dtype) for o in outs] == \
        [(o.shape, o.dtype) for o in gots]
    assert acct.peak - base_meta == card_bytes, (acct.peak - base_meta,
                                                 card_bytes)
    assert _build.meta_cost.flops > 0 and _build.meta_cost.bytes > 0
