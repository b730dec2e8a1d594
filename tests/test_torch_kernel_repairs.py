"""Two repairs of the port's kernels: the paged kernels take f32 as well as
bf16, and the flash kernel takes any head dim up to 288.

On the CPU:
- The decode split plan sizes a split by the element's bytes (half the
  pages in f32), and the split-and-combine at the f32 plan stays inside the
  f32 element-wise bound (``ref.rounding_bound_ratio`` at 2^-14 plus one
  f32 ulp); every broken decode and prefill variant ``chip_smoke.py``
  builds reads above that bound on f32 inputs.
- The flash wrapper's D tail (``flash_attention.run_padded``: zero columns
  up to a multiple of 32, the scale of the true D, the output cut back)
  gives the plain version's output and logsumexp, the route of the padded
  D is the true D's, and the two broken D-tail paths (the scale of the
  padded D, junk in the padded columns) read above the kernel's bound.
  The routing rule: bf16 at D 144 (padded to 160) and at D 288 takes the
  tensor-core kernel and its 2^-8 rounding of P; f32 at D 288 stays on
  the CUDA cores; the paged prefill kernel, built without a D 160
  instantiation, keeps D 144 off its tensor cores.

On the card (``gpu``): the f32 routes launch the f32 decode instantiation
and the CUDA-core prefill kernel, within the bound, with the broken
variants above it; the flash kernel at gemma2-27b's head layout (D 144,
on the tensor cores at its padded 160) and at D 80 within its bound,
logsumexp and gradients, the broken D-tail paths above it.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels import ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the repository root's script)

torch.set_num_threads(2)

# chip_smoke.py's phase-3 shape sets, at the CPU's size
DECODE_SETS = {
    "qwen2-0.5b": dict(KV=2, G=7, D=64, page=16, window=None, softcap=None,
                       lengths=[1, 17, 300, 0, 512, 33]),
    "gemma2-2b": dict(KV=4, G=2, D=288, page=16, window=256, softcap=50.0,
                      lengths=[300, 411, 50, 0]),
}
PREFILL_SETS = {
    "qwen2-0.5b": dict(KV=2, G=7, D=64, page=16, window=None, softcap=None,
                       starts=[0, 40, 129, 300], C=16, q_lens=[16, 9, 0, 1]),
    "gemma2-2b": dict(KV=4, G=2, D=288, page=16, window=256, softcap=50.0,
                      starts=[250, 300, 0, 280], C=16, q_lens=[16, 5, 16, 0]),
}
# head dims that are not multiples of 32: gemma2-27b's layout and D 80
FLASH_TAIL_SETS = {
    "gemma2-27b D 144": dict(B=1, S=150, H=32, KV=16, D=144),
    "D 80": dict(B=2, S=130, H=8, KV=2, D=80),
}


def _decode_case(label, dev="cpu"):
    s = dict(DECODE_SETS[label])
    return cs.decode_case(torch, np.random.default_rng(len(label) + 3), dev,
                          B=len(s["lengths"]), dtype="float32", **s)


def _prefill_case(label, dev="cpu"):
    s = dict(PREFILL_SETS[label])
    return cs.prefill_case(torch, np.random.default_rng(len(label) + 5), dev,
                           B=len(s["starts"]), dtype="float32", **s)


def _flash_case(label, dev="cpu"):
    return cs.flash_case(torch, np.random.default_rng(len(label)), dev,
                         **FLASH_TAIL_SETS[label])


# ---------------------------------------------------------------------------
# the paged kernels in f32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,KV,pps,page,D", [
    (8, 2, 64, 16, 64), (4, 4, 313, 16, 288), (64, 4, 16, 16, 64),
    (1, 1, 300, 16, 64)])
def test_decode_split_plan_sizes_a_split_by_the_element(B, KV, pps, page, D):
    """f32 K/V take twice the bytes a page: a split holds at most half the
    pages of a bf16 one, within the same shared-memory budget, and the
    bf16 plan is the default's."""
    per2, splits2 = pa.split_plan(B, KV, pps, page, D)
    assert (per2, splits2) == pa.split_plan(B, KV, pps, page, D,
                                            elem_bytes=2)
    per4, splits4 = pa.split_plan(B, KV, pps, page, D, elem_bytes=4)
    assert per4 * splits4 >= pps > per4 * (splits4 - 1)
    assert per4 == 1 or 2 * 4 * page * D * per4 <= pa.KV_SMEM_BYTES
    assert per4 <= per2


@pytest.mark.parametrize("label", list(DECODE_SETS))
def test_f32_decode_split_and_combine_inside_the_bound(label):
    """The split-and-combine at the f32 plan, on f32 inputs, against the
    plain version: inside 2^-14 (|P| @ |V|) / l + one f32 ulp."""
    case = _decode_case(label)
    q, kp, vp, tb, ln = cs.decode_args(case)
    plain, mix = cs.decode_bound(pa, case)
    B, KV, _, D = q.shape
    per, _ = pa.split_plan(B, KV, tb.shape[1], kp.shape[1], D,
                           elem_bytes=4)
    got = ref.paged_attention_split_ref(q, kp, vp, tb, ln,
                                        pages_per_split=per,
                                        window=case["window"],
                                        softcap=case["softcap"])
    assert got.dtype == torch.float32
    assert ref.rounding_bound_ratio(got, plain, mix, pa.P_ROUNDING) <= 1.0


@pytest.mark.parametrize("label,which", [("qwen2-0.5b", i) for i in range(3)]
                         + [("gemma2-2b", i) for i in range(3)])
def test_f32_decode_broken_variants_exceed_the_bound(label, which):
    """Each broken decode kernel (a split's partial left out of the combine
    at the f32 plan, each row's newest key missed, a trash entry read
    unmasked; gemma2's window one key wider and narrower) reads above the
    f32 bound."""
    case = _decode_case(label)
    plain, mix = cs.decode_bound(pa, case)
    what, wrong = cs.decode_wrongs(torch, pa, ref, case)[which]
    assert ref.rounding_bound_ratio(wrong(), plain, mix,
                                    pa.P_ROUNDING) > 1.0, what


def test_f32_prefill_routes_to_the_cuda_core_kernel():
    """f32 at every head dim takes the CUDA-core kernel and its bound;
    bf16 keeps its routes."""
    for D in (32, 64, 96, 128, 288):
        assert not pp.tensor_core_route(torch.float32, D)
        assert pp.p_rounding(torch.float32, D) == 2.0 ** -14
    # bf16 at gemma2-2b's 288 has its tensor-core route
    assert pp.tensor_core_route(torch.bfloat16, 64)
    assert pp.tensor_core_route(torch.bfloat16, 288)
    assert not pp.tensor_core_route(torch.bfloat16, 160)


@pytest.mark.parametrize("label,which", [("qwen2-0.5b", i) for i in range(3)]
                         + [("gemma2-2b", i) for i in range(5)])
def test_f32_prefill_broken_variants_exceed_the_bound(label, which):
    """Each broken prefill kernel (the causal mask one key late, each row's
    last partial page dropped, the padding rows written as queries;
    gemma2's window one key wider and narrower) reads above the f32 bound
    on f32 inputs, and the plain version sits inside it."""
    case = _prefill_case(label)
    plain, mix, p_rel = cs.prefill_bound(pp, case)
    assert p_rel == 2.0 ** -14
    assert ref.rounding_bound_ratio(plain, plain, mix, p_rel) == 0.0
    what, wrong = cs.prefill_wrongs(torch, pa, pp, ref, case)[which]
    assert ref.rounding_bound_ratio(wrong(), plain, mix, p_rel) > 1.0, what


# ---------------------------------------------------------------------------
# the flash kernel's D tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,want", [(32, 32), (64, 64), (80, 96), (100, 128),
                                    (144, 160), (288, 288), (1, 32)])
def test_padded_head_dim(D, want):
    assert fa.padded_head_dim(D) == want
    assert fa.tensor_core_route(torch.bfloat16, D) == \
        fa.tensor_core_route(torch.bfloat16, want)


def test_d144_takes_the_tensor_cores_and_288_the_cuda_cores():
    """bf16 at gemma2-27b's D 144 (padded to 160, an instantiation of the
    tensor-core kernel) routes to the tensor cores, with P's bf16 rounding
    in its bound; so does gemma2-2b's 288 (and a D that pads to it);
    f32 at 288 and every other f32 call stay on the CUDA cores,
    as does bf16 at 192; the paged prefill kernel keeps its own head
    dims."""
    assert fa.padded_head_dim(144) == 160
    for D in (144, 160, 136):
        assert fa.tensor_core_route(torch.bfloat16, D)
        assert fa.p_rounding(torch.bfloat16, D) == 2.0 ** -8
        assert not fa.tensor_core_route(torch.float32, D)
        assert not pp.tensor_core_route(torch.bfloat16, D)
    for D in (288, 260):
        assert fa.tensor_core_route(torch.bfloat16, D)
        assert fa.p_rounding(torch.bfloat16, D) == 2.0 ** -8
        assert not fa.tensor_core_route(torch.float32, D)
        assert fa.p_rounding(torch.float32, D) == 2.0 ** -14
    assert not fa.tensor_core_route(torch.bfloat16, 192)
    assert fa.p_rounding(torch.bfloat16, 192) == 2.0 ** -14
    assert fa.TENSOR_CORE_HEAD_DIMS == (32, 64, 96, 128, 160, 288)


@pytest.mark.parametrize("label", list(FLASH_TAIL_SETS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_call_gives_the_plain_result(label, dtype):
    """The wrapper's D handling run through the plain version (zero
    columns up to the next multiple of 32, the true D's scale, the output
    cut back) against the plain version at the true D: the logsumexp to
    f32 rounding, the output to f32 rounding (bf16: within one bf16 ulp,
    the padded sums rounding once more)."""
    c = _flash_case(label)
    dt = getattr(torch, dtype)
    q, k, v = (c[n].to(dt) for n in "qkv")
    kw = c["kw"]
    want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    got, lse = fa.run_padded(fa.flash_attention_plain, q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert got.is_contiguous()
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-6)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert ref.rounding_bound_ratio(got, want, torch.zeros_like(
            got, dtype=torch.float32), 0.0) <= 1.0
    # an explicit scale passes through unchanged
    got_s, _ = fa.run_padded(fa.flash_attention_plain, q, k, v, scale=0.3,
                             **kw)
    want_s, _ = fa.flash_attention_plain(q, k, v, scale=0.3, **kw)
    torch.testing.assert_close(got_s.float(), want_s.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("label", list(FLASH_TAIL_SETS))
@pytest.mark.parametrize("which", [0, 1])
def test_broken_d_tail_exceeds_the_bound(label, which):
    """The scale taken from the padded D, or junk left in the padded
    columns of q and k, reads above the bound of the kernel the true D
    routes to."""
    c = _flash_case(label)
    q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
    plain, mix, p_rel = cs.flash_bound(fa, q, k, v, kw)
    what, wrong = cs.flash_pad_wrongs(torch, fa, q, k, v, kw)[which]
    assert ref.rounding_bound_ratio(wrong(), plain, mix, p_rel) > 1.0, what


def test_route_counters_are_registered_and_idle_on_the_cpu():
    """The D tail and each decode instantiation count under their own
    names in the launch registry; a CPU call runs the plain version and
    counts no launch."""
    from repro_torch.kernels import _build
    assert _build.counters["flash_d_tail"] is fa.flash_d_tail
    for dtype, name in pa.KERNEL_DTYPES.items():
        assert _build.counters[f"decode_{name}"] is pa.DTYPE_LAUNCHES[dtype]
    before = _build.launch_counts()
    c = _flash_case("D 80")
    fa.flash_attention(c["q"], c["k"], c["v"], **c["kw"])
    assert _build.launch_counts() == before


def test_any_head_dim_up_to_288_passes_the_wrapper_checks():
    """``_check_cuda`` takes D 144 and 80 now, and still refuses D past
    288."""
    ok = torch.zeros((1, 4, 2, 144))
    fa._check_cuda(ok, ok, ok)
    fa._check_cuda(ok[..., :80].contiguous(), ok[..., :80].contiguous(),
                   ok[..., :80].contiguous())
    big = torch.zeros((1, 4, 1, 304))
    with pytest.raises(ValueError, match="up to 288"):
        fa._check_cuda(big, big, big)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(DECODE_SETS))
def test_cuda_f32_decode_within_bound(cuda, label):
    """f32 decode launches the f32 instantiation (its counter), writes f32,
    within 2^-14 (|P| @ |V|) / l + one f32 ulp; the broken variants read
    above."""
    case = _decode_case(label, cuda)
    f32, bf16 = (pa.DTYPE_LAUNCHES[torch.float32],
                 pa.DTYPE_LAUNCHES[torch.bfloat16])
    n32, nbf = f32.launches, bf16.launches
    got = pa.paged_attention(*cs.decode_args(case), window=case["window"],
                             softcap=case["softcap"])
    torch.cuda.synchronize()
    assert f32.launches == n32 + 1
    assert bf16.launches == nbf
    assert got.dtype == torch.float32
    plain, mix = cs.decode_bound(pa, case)
    assert ref.rounding_bound_ratio(got, plain, mix, pa.P_ROUNDING) <= 1.0
    for what, wrong in cs.decode_wrongs(torch, pa, ref, case):
        assert ref.rounding_bound_ratio(wrong(), plain, mix,
                                        pa.P_ROUNDING) > 1.0, what


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(PREFILL_SETS))
def test_cuda_f32_prefill_within_bound(cuda, label):
    """f32 prefill launches the CUDA-core kernel, within the f32 bound,
    padding rows zero; the broken variants read above."""
    case = _prefill_case(label, cuda)
    n_tc, n_cc = (pp.prefill_tensor_core.launches,
                  pp.prefill_cuda_core.launches)
    got = pp.paged_prefill(*cs.prefill_args(case), group=case["group"],
                           window=case["window"], softcap=case["softcap"])
    torch.cuda.synchronize()
    assert pp.prefill_cuda_core.launches == n_cc + 1
    assert pp.prefill_tensor_core.launches == n_tc
    assert got.dtype == torch.float32
    plain, mix, p_rel = cs.prefill_bound(pp, case)
    assert ref.rounding_bound_ratio(got, plain, mix, p_rel) <= 1.0
    assert cs.padding_rows_zero(got, case)
    for what, wrong in cs.prefill_wrongs(torch, pa, pp, ref, case):
        assert ref.rounding_bound_ratio(wrong(), plain, mix,
                                        p_rel) > 1.0, what


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(FLASH_TAIL_SETS))
def test_cuda_flash_d_tail_within_bound(cuda, label):
    """The flash kernel at a head dim that is not a multiple of 32: the
    route of the true D (tensor cores at D 80, and at D 144 through the D
    160 instantiation), the output within that kernel's bound (P rounded
    to bf16: 2^-8), the logsumexp within 1e-3, the gradients within 2e-2
    of the largest; the broken D-tail paths above the bound."""
    c = _flash_case(label, cuda)
    q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
    D = q.shape[-1]
    n_tc, n_tail = fa.flash_fwd_tensor_core.launches, fa.flash_d_tail.launches
    out, lse = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.tensor_core_route(q.dtype, D)
    assert fa.flash_fwd_tensor_core.launches == n_tc + 1
    assert fa.flash_d_tail.launches == n_tail + 1
    assert out.shape == q.shape
    plain, mix, p_rel = cs.flash_bound(fa, q, k, v, kw)
    assert p_rel == 2.0 ** -8
    assert ref.rounding_bound_ratio(out, plain, mix, p_rel) <= 1.0
    _, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    assert (lse - want_lse).abs().max().item() <= cs.LSE_TOL
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.mha_flash_attention(*ins, **kw), ins,
                              c["dout"])
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_plain(*ins, **kw)[0], ins,
                               c["dout"])
    for g, w in zip(got, want):
        assert ((g.float() - w.float()).abs().max()
                / w.float().abs().max()).item() <= cs.GRAD_TOL
    for what, wrong in cs.flash_pad_wrongs(torch, fa, q, k, v, kw):
        assert ref.rounding_bound_ratio(wrong(), plain, mix,
                                        p_rel) > 1.0, what
    assert math.isfinite(lse.float().max().item())
