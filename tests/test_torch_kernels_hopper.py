"""The redesigned kernels (flash forward, paged decode, the int8 flash
kernel, paged prefill): what their designs and stated rounding promise,
checked on the CPU.

- The split-context decode kernel's page ranges (``split_plan`` from shapes,
  ``ref.paged_split_ranges``) cover every reachable page of every row
  exactly once, and its split-and-combine (``ref.paged_attention_split_ref``)
  equals ``paged_attention_ref`` to f32 rounding, neutral partials included.
- The same for the int8 kernel's key ranges (``int8_split_plan``,
  ``ref.int8kv_split_ranges``; its split-and-combine ``ref.int8kv_split_ref``
  within one bf16 ulp of ``attention_int8kv_ref``) and paged prefill's
  (``paged_prefill.split_plan``, ``ref.prefill_split_ranges``); the prefill
  kernel's tile loop (``ref.paged_prefill_tiles_ref``: bf16 P, the
  kernel's key tiles over pages, 32 keys at gemma2-2b's D 288, splits,
  combine) stays inside its bound, against the plain version and the
  reference's Pallas kernel (interpret mode), and every broken variant
  ``chip_smoke.py`` builds falls outside it.
- ``_build._target`` names a new library when a header changes.
- The tensor-core flash kernel's loop with P rounded to bf16
  (``ref.flash_tiles_ref``) stays inside the element-wise bound
  ``chip_smoke.py`` holds the kernel to (``ref.rounding_bound_ratio``), on
  the qwen2-0.5b and gemma2-2b head shapes at small sizes (gemma2-2b's
  D 288 in 32-key tiles), and against the
  reference's Pallas kernel (interpret mode); every broken variant that
  ``chip_smoke.py`` builds exceeds the bound, for both kernels, so the
  check's power is shown here and not only on the card.
- The tensor-core SSD scan's decomposition (``ref.ssd_tiles_ref``: CB per
  group, chunk states, the state passing, row tiles; M, w x and h_enter as
  bf16 hi + lo pairs) stays inside its element-wise bound against the
  plain version and the reference's Pallas kernel (interpret mode) at small
  mamba2-like shapes, and every broken scan ``chip_smoke.py`` builds fails
  it; its route is a rule on dtype and shapes.
- The one-pass RMSNorm kernel's layout of a row (``rmsnorm.one_pass_plan``,
  ``ref.rmsnorm_one_pass_ref``) is within one bf16 ulp of the plain version
  and each broken variant fails that rule; its route is a rule on d and
  alignment.
- The ``gpu`` tests at the end hold the CUDA kernels to the same bounds on
  a machine with a card (``python -m pytest -m gpu tests/``).
"""
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import paged_prefill as jpp
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd

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
    # 160: the tensor-core kernel's instantiation for gemma2-27b's D 144;
    # 288: gemma2-2b's, in 32-key tiles
    for D in (32, 64, 96, 128, 160, 288):
        assert fa.tensor_core_route(torch.bfloat16, D)
        assert fa.p_rounding(torch.bfloat16, D) == 2.0 ** -8
    assert [ref.tc_key_tile(D) for D in (64, 160, 288)] == [64, 64, 32]
    for dt, D in ((torch.float32, 64), (torch.bfloat16, 192),
                  (torch.bfloat16, 256), (torch.float32, 288)):
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
    ("gemma2-2b", i) for i in range(3)]


@pytest.mark.parametrize("label,which", FLASH_WRONGS)
def test_flash_broken_variants_exceed_the_bound(label, which):
    """Each broken flash kernel ``chip_smoke.py`` builds (causal mask one
    key late, last partial tile dropped, kv head h % KV, l not rescaled;
    gemma2's window one key wider and narrower, l not rescaled in its
    32-key tiles) reads above the tensor-core bound, the looser of the
    two."""
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
# the int8 kernel split over the key axis
# ---------------------------------------------------------------------------


def _visible_keys(q_start, kv_len, Skv, G, row0, rows, window):
    """The keys any folded row of the tile can see (causal)."""
    seen = set()
    for r in range(row0, row0 + rows):
        qpos = q_start + r // G
        lo = max(0, qpos - window + 1) if window else 0
        seen |= set(range(lo, min(kv_len, Skv, qpos + 1)))
    return seen


@pytest.mark.parametrize("window", [None, 1, 17, 64])
@pytest.mark.parametrize("Sq,G", [(1, 7), (5, 2), (40, 1)])
def test_int8_split_ranges_cover_each_visible_key_once(window, Sq, G):
    """For every kv_len 0..Skv (queries ending at kv_len - 1, or at the
    stripe's start), every row tile, and every split the plan gives at B 8
    and B 1, the splits' key ranges are disjoint and their union is exactly
    the keys the tile's rows can see."""
    Skv, ROWS = 200, fa.INT8_ROWS
    R = Sq * G
    plans = {fa.int8_split_plan(B, 2, Skv, 64, R) for B in (1, 8)}
    plans |= {(16, -(-Skv // 16)), (Skv + 16, 1)}
    for per, splits in plans:
        for kv_len in range(0, Skv + 1):
            for q_start in {max(0, kv_len - Sq), 0}:
                for row0 in range(0, R, ROWS):
                    rows = min(ROWS, R - row0)
                    seen = []
                    for s, rg in enumerate(ref.int8kv_split_ranges(
                            q_start, kv_len, Skv, G, per, splits, row0=row0,
                            rows=rows, window=window)):
                        if rg is not None:
                            a, b = rg
                            assert s * per <= a < b <= (s + 1) * per
                            seen.extend(range(a, b))
                    assert len(seen) == len(set(seen))
                    assert set(seen) == _visible_keys(
                        q_start, kv_len, Skv, G, row0, rows, window), \
                        (per, kv_len, q_start, row0)


@pytest.mark.parametrize("B,KV,Skv,D,rows,want", [
    (8, 2, 2048, 64, 7, (64, 32)),    # dense decode timing shapes: 512 blocks
    (1, 2, 1024, 64, 7, (16, 64)),    # prompt replay at B = 1: 128 blocks
    (2, 1, 128, 64, 128, (16, 8)),    # the TPU test's Sq = 128: 8 row tiles
    (4, 4, 5000, 288, 2, (64, 79)),   # gemma2-2b: shared memory caps it
    (1, 2, 1, 64, 7, (16, 1)),
])
def test_int8_split_plan_from_shapes(B, KV, Skv, D, rows, want):
    """The plan covers the stripe with splits of one size, a multiple of
    16 keys within the shared-memory budget, and gives the grid about 4
    blocks per SM of an H100 unless the 16-key minimum is the limit."""
    per, splits = fa.int8_split_plan(B, KV, Skv, D, rows)
    assert (per, splits) == want
    assert per * splits >= Skv > per * (splits - 1)
    assert per % fa.INT8_KEY_UNIT == 0
    assert fa.int8_smem_bytes(D, per) <= fa.INT8_SMEM_BYTES
    tiles = -(-rows // fa.INT8_ROWS)
    assert per == fa.INT8_KEY_UNIT or \
        2 * B * KV * tiles * splits > pa.BLOCKS_PER_SM * pa.SM_COUNT


INT8_SETS = {
    # dense decode: positions 0, Skv - 1 and a middle one; a row with no key
    "decode": dict(Sq=1, H=14, KV=2, D=64, Skv=300, q_start=[0, 299, 150, 7],
                   kv_len=[1, 300, 151, 0]),
    # several queries per row, window and softcap
    "Sq 5, window": dict(Sq=5, H=4, KV=2, D=32, Skv=70, q_start=[10, 65],
                         kv_len=[15, 70], window=9, softcap=30.0),
    # the TPU kernel's function in f32: q_start 0, kv_len Skv
    "TPU (2, 128, 128, 64)": dict(Sq=128, H=1, KV=1, D=64, Skv=128,
                                  q_start=[0, 0], kv_len=[128, 128],
                                  dtype="float32"),
}


def _int8_set(label):
    c = cs.int8_case(torch, np.random.default_rng(len(label)), "cpu",
                     **INT8_SETS[label])
    return cs.int8_args(c), c["kw"]


def _int8_err(got, want):
    if got.dtype == torch.bfloat16:
        return cs.int8_rel_err(got, want), cs.INT8_BF16_RTOL
    return (got - want).abs().max().item(), cs.INT8_F32_TOL


@pytest.mark.parametrize("splits", [1, 2, 7, 32])
@pytest.mark.parametrize("label", list(INT8_SETS))
def test_int8_split_and_combine_within_one_ulp(label, splits):
    """The int8 kernel's split-and-combine in f32 against its plain version:
    bf16 within one ulp element by element, f32 within 1e-5, for splits 1,
    2, 7 and 32 (ranges of 16-key multiples)."""
    args, kw = _int8_set(label)
    want = ref.attention_int8kv_ref(*args, **kw)
    Skv = args[1].shape[1]
    per = -(-(-(-Skv // splits)) // 16) * 16
    got = ref.int8kv_split_ref(*args, keys_per_split=per, **kw)
    err, tol = _int8_err(got, want)
    assert err <= tol
    for b, n in enumerate(args[6].tolist()):
        if n == 0:
            assert (got[b] == 0).all()


def test_int8_dropped_split_partial_breaks_the_rule():
    """A combine that leaves out each row's first live partial (the broken
    variant ``chip_smoke.py`` adds) fails the one-ulp rule."""
    args, kw = _int8_set("decode")
    q, _, _, _, _, qs, n = args
    B, Sq, H, D = q.shape
    KV, Skv = args[1].shape[2], args[1].shape[1]
    G = H // KV
    per, splits = fa.int8_split_plan(B, KV, Skv, D, Sq * G)
    keep = cs.drop_first_live(torch, [ref.int8kv_split_ranges(
        a, b, Skv, G, per, splits, row0=0, rows=Sq * G)
        for a, b in zip(qs.tolist(), n.tolist())])
    wrong = ref.int8kv_split_ref(*args, keys_per_split=per, keep=keep, **kw)
    want = ref.attention_int8kv_ref(*args, **kw)
    assert _int8_err(wrong, want)[0] > cs.INT8_BF16_RTOL


# ---------------------------------------------------------------------------
# paged prefill on tensor cores, split over the context
# ---------------------------------------------------------------------------

PREFILL_SETS = {
    # chip_smoke.py's qwen2-0.5b prefill set: ragged q_lens, a q_len 0 row
    "qwen2-0.5b": dict(KV=2, G=7, D=64, page=16, window=None, softcap=None,
                       starts=[0, 40, 129, 300], C=16, q_lens=[16, 9, 0, 1]),
    # gemma2-2b's head shapes with a window shorter than the history
    "gemma2-2b": dict(KV=4, G=2, D=288, page=16, window=256, softcap=50.0,
                      starts=[250, 300, 0, 280], C=16, q_lens=[16, 5, 16, 0]),
}


def _prefill_set(label):
    s = dict(PREFILL_SETS[label])
    return cs.prefill_case(torch, np.random.default_rng(len(label) + 1),
                           "cpu", B=len(s["starts"]), **s)


@pytest.mark.parametrize("window", [None, 1, 17, 100])
def test_prefill_split_ranges_cover_each_visible_key_once(window):
    """For every start 0..200, every q_len 0..C, every row tile of a
    C = 16 chunk at G = 7 (one tile of 128 rows) and G = 2 with 64-row
    tiles, and splits of 1, 2 and 4 tiles, the splits' key ranges are
    disjoint and their union is exactly what the tile's valid queries can
    see."""
    page, pps, C = 16, 15, 16
    T = pps * page
    for G, tile in ((7, 128), (2, 64), (2, 16)):
        for per in (64, 128, 256):
            splits = -(-T // per)
            for start in range(0, T - C + 1, 7):
                for q_len in range(0, C + 1):
                    for row0 in range(0, C * G, tile):
                        rows = min(tile, C * G - row0)
                        seen = []
                        for s, rg in enumerate(ref.prefill_split_ranges(
                                start, q_len, T, G, per, splits, row0=row0,
                                rows=rows, window=window)):
                            if rg is not None:
                                a, b = rg
                                assert s * per <= a < b <= (s + 1) * per
                                seen.extend(range(a, b))
                        want = set()
                        for c in range(row0 // G,
                                       min((row0 + rows - 1) // G + 1, q_len)):
                            p = start + c
                            lo = max(0, p - window + 1) if window else 0
                            want |= set(range(lo, min(p + 1, T)))
                        assert len(seen) == len(set(seen))
                        assert set(seen) == want, (G, per, start, q_len)


@pytest.mark.parametrize("B,KV,pps,page,D,rows,want", [
    (4, 2, 68, 16, 64, 112, (64, 17)),   # the launcher's C = 16 round
    (4, 2, 68, 16, 64, 448, (64, 17)),   # C = 64: four row tiles
    (1, 2, 64, 16, 128, 16, (64, 16)),
    (64, 2, 64, 16, 64, 112, (256, 4)),  # large batch: few splits
])
def test_prefill_split_plan_from_shapes(B, KV, pps, page, D, rows, want):
    """The plan covers the table with splits of whole 64-key tiles and
    gives the grid about 4 blocks per SM of an H100 unless one tile a split
    is the limit."""
    per, splits = pp.split_plan(B, KV, pps, page, D, rows)
    assert (per, splits) == want
    assert per % pp.TILE_KEYS == 0
    assert per * splits >= pps * page > per * (splits - 1)
    tiles = -(-rows // (128 if D <= 64 else 64))
    assert per == pp.TILE_KEYS or \
        2 * B * KV * tiles * splits > pa.BLOCKS_PER_SM * pa.SM_COUNT


def test_prefill_route_is_a_rule_on_dtype_and_head_dim():
    for D in (32, 64, 96, 128, 288):
        assert pp.tensor_core_route(torch.bfloat16, D)
        assert pp.p_rounding(torch.bfloat16, D) == 2.0 ** -8
    for dt, D in ((torch.float32, 64), (torch.bfloat16, 48),
                  (torch.bfloat16, 160), (torch.float32, 288)):
        assert not pp.tensor_core_route(dt, D)
        assert pp.p_rounding(dt, D) == 2.0 ** -14


@pytest.mark.parametrize("label", list(PREFILL_SETS))
def test_prefill_tile_loop_stays_inside_the_bound(label):
    """The tensor-core kernel's loop (bf16 P, 64-key tiles over pages,
    splits at the card's plan and at one split, combine) against the plain
    version: inside the bound at p = 2^-8, padding rows zero; with P kept in
    f32, inside the 2^-14 bound the CUDA-core kernel is held to."""
    case = _prefill_set(label)
    plain, mix, _ = cs.prefill_bound(pp, case)
    q, kp, vp, tb, st, ql = cs.prefill_args(case)
    B, KV, CG, D = q.shape
    T = tb.shape[1] * kp.shape[1]
    per, _ = pp.split_plan(B, KV, tb.shape[1], kp.shape[1], D, CG)
    kw = dict(group=case["group"], window=case["window"],
              softcap=case["softcap"])
    for kps in sorted({per, -(-T // 64) * 64}):
        got = ref.paged_prefill_tiles_ref(*cs.prefill_args(case),
                                          keys_per_split=kps, **kw)
        assert got.dtype == torch.bfloat16
        assert ref.rounding_bound_ratio(got, plain, mix, 2.0 ** -8) <= 1.0
        assert cs.padding_rows_zero(got, case)
    got32 = ref.paged_prefill_tiles_ref(*cs.prefill_args(case),
                                        keys_per_split=per,
                                        p_dtype=torch.float32, **kw)
    assert ref.rounding_bound_ratio(got32, plain, mix, 2.0 ** -14) <= 1.0


@pytest.mark.parametrize("label", list(PREFILL_SETS))
def test_prefill_tile_loop_against_the_pallas_kernel(label):
    """The same tile loop (at the card's split plan; gemma2-2b's D 288 in
    32-key tiles) against the reference's Pallas kernel in interpret mode
    on the same bf16 inputs, within the bound plus one ulp of the
    reference's own bf16 output; padding rows zero in both."""
    case = _prefill_set(label)
    q, kp, vp, tb, st, ql = cs.prefill_args(case)
    B, KV, CG, D = q.shape
    per, _ = pp.split_plan(B, KV, tb.shape[1], kp.shape[1], D, CG)
    kw = dict(group=case["group"], window=case["window"],
              softcap=case["softcap"])
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    ji = lambda t: jnp.asarray(t.numpy())
    want = jpp.paged_prefill(j(q), j(kp), j(vp), ji(tb), ji(st), ji(ql),
                             interpret=True, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)
    _, mix, _ = cs.prefill_bound(pp, case)
    emu = ref.paged_prefill_tiles_ref(q, kp, vp, tb, st, ql,
                                      keys_per_split=per, **kw)
    assert ref.rounding_bound_ratio(emu, want, mix, 2.0 ** -8) <= 1.0
    assert cs.padding_rows_zero(want, case)


# both sets run on the tensor cores (gemma2-2b's D 288 since it has a
# route there): qwen2's four variants, and gemma2's window one key wider
# and narrower besides
PREFILL_WRONGS = [("qwen2-0.5b", i) for i in range(4)] + [
    ("gemma2-2b", i) for i in range(6)]


@pytest.mark.parametrize("label,which", PREFILL_WRONGS)
def test_prefill_broken_variants_exceed_the_bound(label, which):
    """Each broken prefill kernel ``chip_smoke.py`` builds (on the
    tensor-core route a split's partial left out of the combine; causal mask
    one key late, each row's last partial page dropped, the padding rows
    written as queries; gemma2's window one key wider and narrower) reads
    above the bound of the kernel its shapes route to."""
    case = _prefill_set(label)
    plain, mix, p_rel = cs.prefill_bound(pp, case)
    what, wrong = cs.prefill_wrongs(torch, pa, pp, ref, case)[which]
    assert ref.rounding_bound_ratio(wrong(), plain, mix, p_rel) > 1.0, what


def test_build_target_changes_when_a_header_changes(tmp_path):
    """A kernel's library is named by a hash of its source and of every
    header beside it: editing or adding a header names a new library, so a
    stale one is never reused."""
    csrc = Path(_build.__file__).resolve().parent / "csrc"
    for f in (*csrc.glob("*.cu"), *csrc.glob("*.cuh")):
        shutil.copy(f, tmp_path / f.name)
    src = tmp_path / "paged_prefill.cu"
    first = _build._target(src)
    assert first == _build._target(src)
    assert first.name == _build._target(csrc / "paged_prefill.cu").name
    header = tmp_path / "split_combine.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build._target(src)
    assert second != first
    (tmp_path / "new.cuh").write_text("#pragma once\n")
    assert _build._target(src) not in (first, second)


# ---------------------------------------------------------------------------
# the SSD scan on tensor cores, parallel over chunks
# ---------------------------------------------------------------------------

def test_ssd_tensor_core_route_is_a_rule_on_dtype_and_shapes():
    for N, P, L in ((128, 64, 256), (64, 64, 256), (16, 16, 64),
                    (128, 48, 192), (32, 32, 128)):
        assert ssd.tensor_core_route(torch.bfloat16, N, P, L)
    for dt, N, P, L in ((torch.float32, 128, 64, 256),   # f32
                        (torch.bfloat16, 16, 32, 16),    # the smoke config
                        (torch.bfloat16, 136, 64, 256),  # N past 128
                        (torch.bfloat16, 120, 64, 256),  # N not 16k
                        (torch.bfloat16, 128, 40, 256),  # P not 16k
                        (torch.bfloat16, 128, 64, 96),   # L not 64k
                        (torch.bfloat16, 128, 64, 512)):  # L past 256
        assert not ssd.tensor_core_route(dt, N, P, L)


def _ssd_set(G):
    """Small mamba2-like shapes: N 128, P 64, chunk 64 over S 256 (four
    chunks: the state carries and decays), H 4 over G groups."""
    c = cs.ssd_case(torch, np.random.default_rng(G), "cpu", b=2, S=256, H=4,
                    P=64, G=G, N=128)
    return (c["x"], c["dt"], c["A"], c["B"], c["C"])


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_tiles_stay_inside_the_bound(G):
    """The tensor-core scan's decomposition against the plain version:
    inside 2^-8 mix + 2^-7 |plain| element by element, and inside the
    element-wise 2e-2 check ``chip_smoke.py`` keeps beside it."""
    args = _ssd_set(G)
    plain, mix = cs.ssd_bound(ssd, args, 64)
    emu = ref.ssd_tiles_ref(*args, 64)
    assert emu.dtype == torch.bfloat16
    assert ref.rounding_bound_ratio(emu, plain, mix, ssd.P_ROUNDING) <= 1.0
    assert cs.norm_err(emu, plain) <= cs.KERNEL_TOL


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_tiles_against_the_pallas_kernel(G):
    """The same decomposition against the reference's Pallas kernel
    (interpret mode, heads folded, B and C repeated per head) on the same
    bf16 inputs, within the bound plus one ulp of the reference's own bf16
    output."""
    x, dt, A, B, C = args = _ssd_set(G)
    b, S, H, P = x.shape
    rep = H // G
    fold = lambda t: jnp.asarray(t.float().transpose(1, 2).reshape(
        b * H, S, -1).numpy(), jnp.bfloat16)
    want = pallas_ssd_scan(
        fold(x), jnp.asarray(dt.transpose(1, 2).reshape(b * H, S).numpy()),
        jnp.asarray(np.tile(A.numpy(), b)),
        fold(B.repeat_interleave(rep, dim=2)),
        fold(C.repeat_interleave(rep, dim=2)), 64, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).reshape(
        b, H, S, P).transpose(1, 2)
    _, mix = cs.ssd_bound(ssd, args, 64)
    emu = ref.ssd_tiles_ref(*args, 64)
    assert ref.rounding_bound_ratio(emu, want.to(torch.bfloat16), mix,
                                    ssd.P_ROUNDING) <= 1.0


SSD_WRONGS = [(1, i) for i in range(5)] + [(2, i) for i in range(6)]


@pytest.mark.parametrize("G,which", SSD_WRONGS)
def test_ssd_broken_variants_fail_the_bound(G, which):
    """Each broken scan ``chip_smoke.py`` builds (the carried state dropped,
    dt 5% off, the mask one row late, h_enter one chunk late, the chunk
    decay exp(seg) left out; at G = 2 head h reading group h % G) fails the
    bound."""
    args = _ssd_set(G)
    plain, mix = cs.ssd_bound(ssd, args, 64)
    wrongs = cs.ssd_wrongs(ssd, ref, args, 64)
    assert len(wrongs) == (6 if G > 1 else 5)
    what, wrong = wrongs[which]
    miss = ref.rounding_bound_ratio(wrong(), plain, mix, ssd.P_ROUNDING)
    assert not miss <= 1.0, what


# ---------------------------------------------------------------------------
# RMSNorm in one pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,want", [
    (896, (1, 128, 2)),      # qwen2-0.5b: two rows a block
    (2048, (1, 256, 1)),
    (2304, (2, 160, 1)),     # gemma2-2b: 288 packs over 160 threads
    (4096, (2, 256, 1)),     # mamba2's gated norm
    (8192, (4, 256, 1)),
    (8, (1, 32, 8)),
])
def test_rmsnorm_one_pass_plan_from_shapes(d, want):
    """The plan covers the row's d / 8 packs with whole warps, at most 4
    packs a thread and 256 threads a block, several rows a block where a
    row needs few threads."""
    ppt, tpr, rpb = rn.one_pass_plan(d)
    assert (ppt, tpr, rpb) == want
    assert tpr % 32 == 0 and tpr * rpb <= rn.ONE_PASS_BLOCK
    assert ppt <= rn.ONE_PASS_MAX_PPT and ppt * tpr * 8 >= d
    assert (tpr - 32) * ppt * 8 < d          # no whole warp idle


def test_rmsnorm_route_is_a_rule_on_d_and_alignment():
    for d in (8, 896, 2048, 2304, 4096, 8192):
        assert rn.one_pass_route(d, True)
        assert not rn.one_pass_route(d, False)
    for d in (100, 8200, 16384):
        assert not rn.one_pass_route(d, True)


def _rms_rows(d, din):
    rng = np.random.default_rng(d)
    return (torch.tensor(rng.standard_normal((37, d)), dtype=din),
            torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32))


@pytest.mark.parametrize("d", [896, 2304, 4096, 8192])
@pytest.mark.parametrize("din,dout", [(torch.bfloat16, torch.bfloat16),
                                      (torch.float32, torch.bfloat16),
                                      (torch.float32, torch.float32)])
def test_rmsnorm_one_pass_layout_within_one_ulp(d, din, dout):
    """The one-pass kernel's sum over its threads and warps meets the rule
    ``chip_smoke.py`` holds the kernel to: one bf16 ulp element by element,
    1e-6 relative for f32 out."""
    x, s = _rms_rows(d, din)
    got = ref.rmsnorm_one_pass_ref(x, s, out_dtype=dout,
                                   plan=rn.one_pass_plan(d))
    assert cs.ulp_ratio(got, rn.rmsnorm_ref(x, s, out_dtype=dout)) <= 1.0


RMS_WRONGS = [(4096, 0), (4096, 1), (2304, 0), (2304, 1), (896, 0)]


@pytest.mark.parametrize("d,which", RMS_WRONGS)
@pytest.mark.parametrize("dout", [torch.bfloat16, torch.float32])
def test_rmsnorm_broken_variants_fail_one_ulp(d, which, dout):
    """Each broken kernel ``chip_smoke.py`` builds (the gain read as scale;
    at d 4,096 one warp's partial left out of the row's sum; at d 2,304 the
    ragged row's last pack not written) fails the one-ulp rule."""
    x, s = _rms_rows(d, torch.float32)
    what, wrong = cs.rmsnorm_wrongs(rn, ref, x, s, dout)[which]
    assert cs.ulp_ratio(wrong(), rn.rmsnorm_ref(x, s, out_dtype=dout)) > 1.0, \
        what


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
    # gemma2-2b's D 288 (32-key tiles, Q re-read from shared memory): a
    # local layer's window and softcap, and a last row tile mostly past Sq
    (1, 300, 300, 8, 4, 288, True, 64, 50.0),
    (2, 130, 130, 2, 1, 288, True, None, None),
    (1, 70, 300, 2, 2, 288, False, None, 30.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window,softcap", TC_CASES)
def test_cuda_tensor_core_flash_within_bound(cuda, B, Sq, Skv, H, KV, D,
                                             causal, window, softcap):
    """bf16 with D <= 128 or 288 goes to the tensor-core kernel (its own
    counter), output within the 2^-8 bound element by element, lse within
    1e-4, rows without a key zeros with lse -inf."""
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


INT8_CARD_CASES = {
    # B = 8 decode against 2,048-position stripes
    "B 8 decode": dict(Sq=1, H=14, KV=2, D=64, Skv=2048,
                       q_start=[0, 63, 64, 500, 1023, 1500, 2000, 2047],
                       kv_len=[1, 64, 65, 501, 1024, 1501, 2001, 2048]),
    # the dense prompt replay: B = 1 against a 1,024-position stripe
    "B 1 replay": dict(Sq=1, H=14, KV=2, D=64, Skv=1024, q_start=[100],
                       kv_len=[101]),
    # gemma2-2b's D = 288 with window and softcap; 4-byte copies at D 20
    "gemma2-2b": dict(Sq=1, H=8, KV=4, D=288, Skv=700, q_start=[600, 0],
                      kv_len=[601, 1], window=256, softcap=50.0),
    "D 20": dict(Sq=3, H=4, KV=2, D=20, Skv=90, q_start=[10, 80],
                 kv_len=[13, 83], window=7),
    "TPU (2, 128, 128, 64)": INT8_SETS["TPU (2, 128, 128, 64)"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(INT8_CARD_CASES))
def test_cuda_int8kv_split_kernel_within_one_ulp(cuda, label):
    """The split int8 kernel against its plain version: bf16 within one ulp
    element by element, f32 within 1e-5; one launch counted."""
    c = cs.int8_case(torch, np.random.default_rng(len(label)), cuda,
                     **INT8_CARD_CASES[label])
    args, kw = cs.int8_args(c), c["kw"]
    n = fa.flash_attention_int8kv.launches
    got = fa.flash_attention_int8kv(*args, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_int8kv.launches == n + 1
    err, tol = _int8_err(got, ref.attention_int8kv_ref(*args, **kw))
    assert err <= tol


PREFILL_CARD_CASES = {
    "qwen2-0.5b": PREFILL_SETS["qwen2-0.5b"],
    "gemma2-2b": PREFILL_SETS["gemma2-2b"],
    # the launcher's round: B = 4 x C = 16, starts 0-1,024
    "B 4 x C 16": dict(KV=2, G=7, D=64, page=16, window=None, softcap=None,
                       starts=[0, 341, 683, 1024], C=16, q_lens=[16] * 4),
    # C = 64 (four row tiles), and B = 1 with D = 128 and a window
    "C 64": dict(KV=2, G=7, D=64, page=16, window=None, softcap=None,
                 starts=[0, 256, 640, 1024], C=64, q_lens=[64, 3, 64, 0]),
    "B 1, D 128": dict(KV=2, G=4, D=128, page=16, window=100, softcap=30.0,
                       starts=[333], C=16, q_lens=[11]),
    # gemma2-2b's D 288 at C = 64 (two row tiles of 64, the second half
    # padding) and at the engine's C = 16 (32 rows: two live warps)
    "gemma2-2b C 64": dict(KV=4, G=2, D=288, page=16, window=256,
                           softcap=50.0, starts=[0, 300, 700], C=64,
                           q_lens=[64, 40, 0]),
    "gemma2-2b C 16": dict(KV=4, G=2, D=288, page=16, window=None,
                           softcap=None, starts=[1000, 17, 512, 0], C=16,
                           q_lens=[16, 16, 1, 7]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(PREFILL_CARD_CASES))
def test_cuda_prefill_within_bound(cuda, label):
    """Paged prefill on the card: the kernel its shapes route to (its own
    counter), within that kernel's bound element by element, padding rows
    and q_len 0 rows zero."""
    s = dict(PREFILL_CARD_CASES[label])
    case = cs.prefill_case(torch, np.random.default_rng(len(label)), cuda,
                           B=len(s["starts"]), **s)
    q = case["q"]
    tc = pp.tensor_core_route(q.dtype, q.shape[-1])
    n_tc, n_cc = (pp.prefill_tensor_core.launches,
                  pp.prefill_cuda_core.launches)
    got = pp.paged_prefill(*cs.prefill_args(case), group=case["group"],
                           window=case["window"], softcap=case["softcap"])
    torch.cuda.synchronize()
    assert pp.prefill_tensor_core.launches == n_tc + tc
    assert pp.prefill_cuda_core.launches == n_cc + (not tc)
    plain, mix, p_rel = cs.prefill_bound(pp, case)
    assert ref.rounding_bound_ratio(got, plain, mix, p_rel) <= 1.0
    assert cs.padding_rows_zero(got, case)


SSD_CARD_CASES = {
    # what a fresh full-width mamba2-1.3b layer feeds the scan
    "mamba2-1.3b": dict(b=1, S=1024, seed=1),
    # G 2 with S not a chunk multiple (ops.ssd pads it)
    "G 2, S 1000": dict(b=1, S=1000, H=64, P=64, G=2, N=128),
    # zamba2-1.2b's N 64, four chunks
    "zamba2 N 64": dict(b=2, S=1024, H=64, P=64, G=1, N=64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(SSD_CARD_CASES))
def test_cuda_tensor_core_ssd_within_bound(cuda, label):
    """The scan through ``ops.ssd`` takes the tensor-core route (its own
    counter), is within 2^-8 mix + 2^-7 |plain| and the 2e-2 element-wise
    check, and every broken scan fails the bound."""
    rng = np.random.default_rng(len(label))
    spec = SSD_CARD_CASES[label]
    c = (cs.mamba_scan_case(torch, rng, cuda, **spec) if "seed" in spec
         else cs.ssd_case(torch, rng, cuda, **spec))
    args = (c["x"], c["dt"], c["A"], c["B"], c["C"])
    S = args[0].shape[1]
    n_tc, n_cc = ssd.ssd_tensor_core.launches, ssd.ssd_cuda_core.launches
    got = ops.ssd(*args, chunk=256)
    torch.cuda.synchronize()
    assert ssd.ssd_tensor_core.launches == n_tc + 1
    assert ssd.ssd_cuda_core.launches == n_cc
    padded = ref.pad_to_chunks(args[0], args[1], args[3], args[4], 256)
    pargs = (padded[0], padded[1], args[2], padded[2], padded[3])
    plain, mix = (t[:, :S] for t in cs.ssd_bound(ssd, pargs, 256))
    assert ref.rounding_bound_ratio(got, plain, mix, ssd.P_ROUNDING) <= 1.0
    assert cs.norm_err(got, plain) <= cs.KERNEL_TOL
    for what, wrong in cs.ssd_wrongs(ssd, ref, pargs, 256):
        miss = ref.rounding_bound_ratio(wrong()[:, :S], plain, mix,
                                        ssd.P_ROUNDING)
        assert not miss <= 1.0, what


@pytest.mark.gpu
@pytest.mark.parametrize("d", [896, 2048, 2304, 4096, 8192])
@pytest.mark.parametrize("din,dout", [(torch.bfloat16, torch.bfloat16),
                                      (torch.float32, torch.bfloat16),
                                      (torch.float32, torch.float32)])
def test_cuda_rmsnorm_one_pass_within_one_ulp(cuda, d, din, dout):
    """The one-pass kernel (its own counter) within one bf16 ulp element by
    element (1e-6 relative for f32 out), over a row count that is not a
    multiple of the block's rows."""
    rng = np.random.default_rng(d)
    x = torch.tensor(rng.standard_normal((1037, d)), dtype=din, device=cuda)
    s = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                     device=cuda)
    n1, n2 = rn.rmsnorm_one_pass.launches, rn.rmsnorm_two_pass.launches
    got = rn.rmsnorm(x, s, out_dtype=dout)
    torch.cuda.synchronize()
    assert rn.rmsnorm_one_pass.launches == n1 + 1
    assert rn.rmsnorm_two_pass.launches == n2
    assert cs.ulp_ratio(got, rn.rmsnorm_ref(x, s, out_dtype=dout)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("d,skew", [(16384, 0),   # past the one-pass kernel
                                    (100, 0),     # d % 8 != 0: element-wise
                                    (4096, 1)])   # rows off 16-byte alignment
@pytest.mark.parametrize("din,dout", [(torch.bfloat16, torch.bfloat16),
                                      (torch.float32, torch.bfloat16),
                                      (torch.float32, torch.float32)])
def test_cuda_rmsnorm_two_pass_within_one_ulp(cuda, d, skew, din, dout):
    """The two-pass kernel (its own counter) within one bf16 ulp element by
    element (1e-6 relative for f32 out), with packs of 8 at d 16,384 and
    element by element at d 100 and on misaligned rows."""
    rng = np.random.default_rng(d + skew)
    x = torch.tensor(rng.standard_normal(1037 * d + skew), dtype=din,
                     device=cuda)[skew:].view(1037, d)
    s = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                     device=cuda)
    n1, n2 = rn.rmsnorm_one_pass.launches, rn.rmsnorm_two_pass.launches
    got = rn.rmsnorm(x, s, out_dtype=dout)
    torch.cuda.synchronize()
    assert rn.rmsnorm_two_pass.launches == n2 + 1
    assert rn.rmsnorm_one_pass.launches == n1
    assert cs.ulp_ratio(got, rn.rmsnorm_ref(x, s, out_dtype=dout)) <= 1.0
