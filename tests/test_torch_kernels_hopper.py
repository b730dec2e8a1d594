"""The redesigned flash forward and paged decode kernels: what their designs
and stated rounding promise, checked on the CPU.

- The split-context decode kernel's page ranges (``split_plan`` from shapes,
  ``ref.paged_split_ranges``) cover every reachable page of every row
  exactly once, and its split-and-combine (``ref.paged_attention_split_ref``)
  equals ``paged_attention_ref`` to f32 rounding, neutral partials included.
- The tensor-core flash kernel's loop with P rounded to bf16
  (``ref.flash_tiles_ref``) stays inside the element-wise bound
  ``chip_smoke.py`` holds the kernel to (``ref.rounding_bound_ratio``), on
  the qwen2-0.5b and gemma2-2b head shapes at small sizes, and against the
  reference's Pallas kernel (interpret mode); every broken variant that
  ``chip_smoke.py`` builds exceeds the bound, for both kernels, so the
  check's power is shown here and not only on the card.
- The ``gpu`` tests at the end hold the CUDA kernels to the same bounds on
  a machine with a card (``python -m pytest -m gpu tests/``).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the repository root's script)

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# split-context decode: the plan and the split-and-combine
# ---------------------------------------------------------------------------


def _reachable(length, page, pps, window):
    if length <= 0:
        return set()
    first = max(0, length - window) // page if window else 0
    return set(range(first, min((length - 1) // page, pps - 1) + 1))


@pytest.mark.parametrize("window", [None, 1, 17, 300, 2048])
def test_split_ranges_cover_each_reachable_page_once(window):
    """For every length 0-2048, with and without a window, and for every
    split of the table the kernel can be given, the splits' page ranges
    are disjoint and their union is exactly the row's reachable pages."""
    page, pps = 16, 128
    pers = sorted({1, 2, 3, 4, 5, 7, 16, 33, 64, 127, 128,
                   pa.split_plan(8, 2, pps, page, 64)[0],
                   pa.split_plan(1, 1, pps, page, 288)[0]})
    for per in pers:
        splits = -(-pps // per)
        for length in range(0, pps * page + 1):
            seen = []
            for s, r in enumerate(ref.paged_split_ranges(
                    length, per, splits, page, pps, window)):
                if r is not None:
                    lo, hi = r
                    assert s * per <= lo <= hi < (s + 1) * per
                    seen.extend(range(lo, hi + 1))
            assert len(seen) == len(set(seen)), (per, length)
            assert set(seen) == _reachable(length, page, pps, window), \
                (per, length)


@pytest.mark.parametrize("B,KV,pps,page,D,want", [
    (8, 2, 128, 16, 64, (4, 32)),     # the timing shapes: 512 blocks
    (6, 2, 32, 16, 64, (1, 32)),      # short table: one page a split
    (4, 4, 313, 16, 288, (2, 157)),   # gemma2-2b: K/V budget caps it at 2
    (64, 4, 16, 16, 64, (6, 3)),      # large batch: few splits
    (1, 1, 1, 8, 32, (1, 1)),
])
def test_split_plan_from_shapes(B, KV, pps, page, D, want):
    """The plan covers the table with splits of one size, keeps a split's
    K/V within the shared memory budget, and gives ``B * KV * splits``
    about 4 blocks per SM of an H100 unless one page a split is the
    limit."""
    per, splits = pa.split_plan(B, KV, pps, page, D)
    assert (per, splits) == want
    assert per * splits >= pps > per * (splits - 1)
    assert per == 1 or 4 * page * D * per <= pa.KV_SMEM_BYTES
    assert per == 1 or 2 * B * KV * splits > pa.BLOCKS_PER_SM * pa.SM_COUNT


def _decode_inputs(rng, *, B, KV, G, D, page, lengths, dtype=torch.float32):
    pps = max(1, -(-max(lengths) // page))
    NP = B * pps + 1
    tbl = rng.permutation(NP - 1)[:B * pps].reshape(B, pps).astype(np.int32)
    for b, n in enumerate(lengths):
        used = -(-n // page)
        tbl[b, used:] = NP - 1                     # trash block
        if used < pps:
            tbl[b, -1] = NP + 4                    # garbage: clamped
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dtype)
    return (mk(B, KV, G, D), mk(NP, page, KV, D), mk(NP, page, KV, D),
            torch.from_numpy(tbl), torch.tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("splits", [1, 2, 7, 32])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 30.0)])
def test_split_and_combine_equals_paged_ref(splits, window, softcap):
    """The split-and-combine version against ``paged_attention_ref`` in
    f32, with rows of length 0, 1 and ones that leave most splits
    neutral."""
    rng = np.random.default_rng(splits)
    q, kp, vp, tbl, lens = _decode_inputs(
        rng, B=6, KV=2, G=7, D=32, page=8, lengths=[0, 1, 9, 100, 256, 17])
    kw = dict(window=window, softcap=softcap)
    want = ref.paged_attention_ref(q, kp, vp, tbl, lens, **kw)
    per = -(-tbl.shape[1] // splits)
    got, (m, l) = ref.paged_attention_split_ref(
        q, kp, vp, tbl, lens, pages_per_split=per, return_partials=True,
        **kw)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    assert (got[0] == 0).all()                     # length 0: zeros
    n = m.shape[2]
    for b, length in enumerate(lens.tolist()):
        live = torch.tensor([r is not None for r in ref.paged_split_ranges(
            length, per, n, 8, tbl.shape[1], window)])
        # a split holds a valid key exactly where its range is live; the
        # others are neutral
        assert ((l[b] > 0).all(dim=-1) == live).all()
        assert (l[b][:, ~live] == 0).all()
        assert (m[b][:, ~live] == ref.NEG_INF).all()
    if splits > 1:
        assert (l == 0).any()                      # neutral partials met


# ---------------------------------------------------------------------------
# the element-wise bounds and their power
# ---------------------------------------------------------------------------

FLASH_SETS = {
    # the training path's head shapes at a small S (not a tile multiple)
    "qwen2-0.5b": dict(B=2, S=200, H=14, KV=2, D=64),
    # gemma2-2b's D = 288 with a window shorter than S and the softcap
    "gemma2-2b": dict(B=1, S=300, H=8, KV=4, D=288, window=64,
                      softcap=50.0),
}


def _flash_set(label):
    rng = np.random.default_rng(len(label))
    c = cs.flash_case(torch, rng, "cpu", **FLASH_SETS[label])
    return c["q"], c["k"], c["v"], c["kw"]


def test_tensor_core_route_is_a_rule_on_dtype_and_head_dim():
    for D in (32, 64, 96, 128):
        assert fa.tensor_core_route(torch.bfloat16, D)
        assert fa.p_rounding(torch.bfloat16, D) == 2.0 ** -8
    for dt, D in ((torch.float32, 64), (torch.bfloat16, 160),
                  (torch.bfloat16, 288), (torch.float32, 288)):
        assert not fa.tensor_core_route(dt, D)
        assert fa.p_rounding(dt, D) == 2.0 ** -14


@pytest.mark.parametrize("label", list(FLASH_SETS))
def test_flash_kernel_rounding_stays_inside_the_bound(label):
    """The kernel's loop with P rounded to bf16 against the plain version:
    inside the bound derived from that rounding, element by element (the
    lse to f32 rounding); with P kept in f32, inside the CUDA-core
    kernel's tighter bound."""
    q, k, v, kw = _flash_set(label)
    plain, mix, _ = cs.flash_bound(fa, q, k, v, kw)
    _, plain_lse = fa.flash_attention_plain(q, k, v, **kw)
    emu, lse = ref.flash_tiles_ref(q, k, v, **kw)
    assert ref.rounding_bound_ratio(emu, plain, mix, 2.0 ** -8) <= 1.0
    torch.testing.assert_close(lse, plain_lse, atol=1e-5, rtol=1e-6)
    emu32, _ = ref.flash_tiles_ref(q, k, v, p_dtype=torch.float32, **kw)
    assert ref.rounding_bound_ratio(emu32, plain, mix, 2.0 ** -14) <= 1.0


@pytest.mark.parametrize("label", list(FLASH_SETS))
def test_flash_kernel_rounding_against_the_pallas_kernel(label):
    """The same emulation against the reference's Pallas kernel (interpret
    mode, heads folded) on the same bf16 inputs, within the bound plus one
    ulp of the reference's own bf16 output."""
    q, k, v, kw = _flash_set(label)
    B, S, H, D = q.shape
    qf, kf, vf = fa._fold_heads(q, k, v)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    want = jfa.flash_attention(j(qf), j(kf), j(vf), interpret=True, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).reshape(
        B, H, S, D).permute(0, 2, 1, 3)
    _, mix, _ = cs.flash_bound(fa, q, k, v, kw)
    emu, _ = ref.flash_tiles_ref(q, k, v, **kw)
    assert ref.rounding_bound_ratio(emu, want.to(torch.bfloat16), mix,
                                    2.0 ** -8) <= 1.0


FLASH_WRONGS = [("qwen2-0.5b", i) for i in range(4)] + [
    ("gemma2-2b", i) for i in range(2)]


@pytest.mark.parametrize("label,which", FLASH_WRONGS)
def test_flash_broken_variants_exceed_the_bound(label, which):
    """Each broken flash kernel ``chip_smoke.py`` builds (causal mask one
    key late, last partial tile dropped, kv head h % KV, l not rescaled;
    gemma2's window one key wider and narrower) reads above the
    tensor-core bound, the looser of the two."""
    q, k, v, kw = _flash_set(label)
    plain, mix, _ = cs.flash_bound(fa, q, k, v, kw)
    what, wrong = cs.flash_wrongs(torch, fa, ref, q, k, v, kw)[which]
    assert ref.rounding_bound_ratio(wrong(), plain, mix, 2.0 ** -8) > 1.0, \
        what


DECODE_SETS = {
    "qwen2-0.5b": dict(KV=2, G=7, D=64, page=16, window=None, softcap=None,
                       lengths=[1, 17, 300, 0, 512, 33]),
    "gemma2-2b": dict(KV=4, G=2, D=288, page=16, window=256, softcap=50.0,
                      lengths=[300, 411, 50, 0]),
}


def _decode_set(label):
    s = dict(DECODE_SETS[label])
    return cs.decode_case(torch, np.random.default_rng(len(label)), "cpu",
                          B=len(s["lengths"]), **s)


@pytest.mark.parametrize("label", list(DECODE_SETS))
def test_decode_split_kernel_stays_inside_the_bound(label):
    """The split-and-combine at the card's plan, on bf16 inputs, against
    the plain version: inside the f32 kernel's bound."""
    case = _decode_set(label)
    q, kp, vp, tb, ln = cs.decode_args(case)
    plain, mix = cs.decode_bound(pa, case)
    B, KV, _, D = q.shape
    per, _ = pa.split_plan(B, KV, tb.shape[1], kp.shape[1], D)
    got = ref.paged_attention_split_ref(q, kp, vp, tb, ln,
                                        pages_per_split=per,
                                        window=case["window"],
                                        softcap=case["softcap"])
    assert got.dtype == torch.bfloat16
    assert ref.rounding_bound_ratio(got, plain, mix, pa.P_ROUNDING) <= 1.0


DECODE_WRONGS = [("qwen2-0.5b", i) for i in range(3)] + [
    ("gemma2-2b", i) for i in range(3)]


@pytest.mark.parametrize("label,which", DECODE_WRONGS)
def test_decode_broken_variants_exceed_the_bound(label, which):
    """Each broken decode kernel ``chip_smoke.py`` builds (a split's partial
    left out of the combine, each row's newest key missed, a trash entry
    read unmasked; gemma2's window one key wider and narrower) reads above
    the bound."""
    case = _decode_set(label)
    plain, mix = cs.decode_bound(pa, case)
    what, wrong = cs.decode_wrongs(torch, pa, ref, case)[which]
    assert ref.rounding_bound_ratio(wrong(), plain, mix,
                                    pa.P_ROUNDING) > 1.0, what


# ---------------------------------------------------------------------------
# on the card: the redesigned kernels at their bounds
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


TC_CASES = [
    # B, Sq, Skv, H, KV, D, causal, window, softcap
    (2, 150, 150, 4, 2, 32, True, None, None),
    (1, 130, 130, 6, 2, 64, True, None, 30.0),
    (2, 200, 200, 4, 1, 128, True, 40, None),
    (1, 257, 257, 4, 4, 96, False, 33, 50.0),
    (1, 150, 100, 4, 2, 64, True, 20, None),   # rows past 119 reach no key
    (1, 70, 300, 2, 2, 64, False, None, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,softcap", TC_CASES)
def test_cuda_tensor_core_flash_within_bound(cuda, B, Sq, Skv, H, KV, D,
                                             causal, window, softcap):
    """bf16 with D <= 128 goes to the tensor-core kernel (its own counter),
    output within the 2^-8 bound element by element, lse within 1e-4,
    rows without a key zeros with lse -inf."""
    rng = np.random.default_rng(Sq + D)
    mk = lambda *s: torch.tensor(rng.standard_normal(s),
                                 dtype=torch.bfloat16, device=cuda)
    q, k, v = mk(B, Sq, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n_tc, n_cc = (fa.flash_fwd_tensor_core.launches,
                  fa.flash_fwd_cuda_core.launches)
    out, lse = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_tensor_core.launches == n_tc + 1
    assert fa.flash_fwd_cuda_core.launches == n_cc
    plain, mix, p_rel = cs.flash_bound(fa, q, k, v, kw)
    assert p_rel == 2.0 ** -8
    assert ref.rounding_bound_ratio(out, plain, mix, p_rel) <= 1.0
    _, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    fin = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - want_lse[fin]).abs().max().item() <= 1e-4
    assert (out.float()[~fin.permute(0, 2, 1)] == 0).all()
