"""The flash kernel's calls without the causal mask and with Sq != Skv:
whisper-small's encoder (1,500 frames, not a multiple of the 64-row
tile), its training cross-attention (448 queries over 1,500 frames) and
its decode cross-attention (one query over 1,500).

On the CPU:
- the backward (``flash_attention_bwd``, PyTorch on any device) at such
  shapes against autograd through the plain version: f32 within 1e-5 of
  the largest gradient, bf16 within 2e-2 (``chip_smoke.GRAD_TOL``);
- every broken variant ``chip_smoke.cross_wrongs`` builds (the causal
  mask applied where none was asked, the last partial key tile dropped,
  Skv taken as Sq) reads above the kernel's element-wise bound
  (``ref.rounding_bound_ratio``), which the plain version itself meets.

On the card (``gpu``, ``chip_smoke.CROSS_SETS``' full shapes): the call
takes the tensor-core kernel, its output is within the bound, its
logsumexp within 1e-3, its gradients within 2e-2 of the largest, and
every broken variant reads above the bound (``chip_smoke.check_cross``).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the repository root's script)

torch.set_num_threads(2)

# the CPU's sizes of the three calls: a square encoder that is not a tile
# multiple, Sq < Skv, one query
SMALL = {"encoder": dict(B=2, Sq=100, Skv=100, H=3, KV=3, D=32),
         "cross": dict(B=2, Sq=37, Skv=100, H=4, KV=2, D=32),
         "decode cross": dict(B=3, Sq=1, Skv=100, H=3, KV=3, D=32)}


def _case(label, dtype=torch.bfloat16, dev="cpu"):
    c = cs.cross_case(torch, np.random.default_rng(len(label)), dev,
                      **SMALL[label])
    return {k: (v.to(dtype) if torch.is_tensor(v) else v)
            for k, v in c.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label", sorted(SMALL))
def test_cross_backward_matches_autograd(label, dtype):
    c = _case(label, getattr(torch, dtype))
    qkv = [c[n] for n in "qkv"]
    ins = [t.clone().requires_grad_(True) for t in qkv]
    got = torch.autograd.grad(ops.mha_flash_attention(*ins, **c["kw"]), ins,
                              c["dout"])
    ins = [t.clone().requires_grad_(True) for t in qkv]
    want = torch.autograd.grad(fa.flash_attention_plain(*ins, **c["kw"])[0],
                               ins, c["dout"])
    tol = 1e-5 if dtype == "float32" else cs.GRAD_TOL
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = ((g.float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        assert err <= tol, err


@pytest.mark.parametrize("label", sorted(SMALL))
def test_cross_wrongs_read_above_the_bound(label):
    c = _case(label)
    qkv, kw = [c[n] for n in "qkv"], c["kw"]
    plain, mix, p_rel = cs.flash_bound(fa, *qkv, kw)
    assert ref.rounding_bound_ratio(plain, plain, mix, p_rel) == 0.0
    wrongs = cs.cross_wrongs(torch, fa, *qkv, kw, tile=64)
    want = {"applied a causal mask where none was asked",
            "dropped the last partial key tile"}
    if c["q"].shape[1] < c["k"].shape[1]:
        want.add("took Skv as Sq")
    assert {w for w, _ in wrongs} == want
    for what, wrong in wrongs:
        assert ref.rounding_bound_ratio(wrong(), plain, mix, p_rel) > 1.0, \
            what


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("label", sorted(cs.CROSS_SETS))
def test_cuda_flash_cross_within_bound(cuda, label):
    from repro_torch.kernels import ops as kops
    case = cs.cross_case(torch, np.random.default_rng(7), cuda,
                         **cs.CROSS_SETS[label])
    r = cs.check_cross(torch, fa, kops, ref, case)
    assert r["tensor_cores"], r
    assert r["ratio"] <= 1.0 and r["lse_err"] <= cs.LSE_TOL, r
    assert r["grad_err"] <= cs.GRAD_TOL, r
    assert r["misses"] and all(m > 1.0 for m in r["misses"].values()), r
