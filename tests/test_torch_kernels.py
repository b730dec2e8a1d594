"""Paged attention kernels: the port's plain versions, through
``repro_torch.kernels.ops``, against the reference's Pallas kernels (in
interpret mode off-TPU, as ``repro.kernels.ops`` chooses) and against
``repro.kernels.ref``, on the same numpy inputs.

Tolerances: atol 1e-5 with f32 inputs (both sides compute in f32; only
the summation order differs); atol 2e-2 with bf16 inputs (outputs are
rounded to bf16: one bf16 ulp at |x| ~ 4).  The CUDA kernels themselves
are held against the plain versions by the ``gpu`` tests at the end,
which run on a machine with a card (``python -m pytest -m gpu tests/``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _make_tables(rng, B, pps, page, NP, extents):
    t = rng.integers(0, NP - 1, (B, pps)).astype(np.int32)
    for b, n in enumerate(extents):
        used = -(-n // page)
        t[b, used:] = NP - 1                       # trash block
        if used < pps:
            t[b, -1] = NP + 3                      # garbage: clamped
    return t


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch tensor of ``dtype``."""
    if dtype == "bf16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _close(ours, theirs, atol):
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(theirs).astype(np.float32),
                               atol=atol, rtol=0)


DECODE_CASES = [
    # G, D, page, window, softcap, dtype
    (2, 32, 8, None, None, "f32"),
    (7, 64, 16, None, None, "bf16"),
    (2, 64, 8, 11, None, "f32"),       # window shorter than the context
    (7, 32, 16, None, 30.0, "f32"),    # softcap
    (7, 64, 8, 20, 50.0, "bf16"),      # window + softcap
]


@pytest.mark.parametrize("G,D,page,window,softcap,dtype", DECODE_CASES)
def test_decode_matches_reference(G, D, page, window, softcap, dtype):
    rng = np.random.default_rng(G * 100 + D + page)
    B, KV, pps = 4, 2, 5
    NP = B * pps + 1
    lengths = np.array([1, page * pps, 0, 2 * page + 3], np.int32)
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    kp = rng.standard_normal((NP, page, KV, D)).astype(np.float32)
    vp = rng.standard_normal((NP, page, KV, D)).astype(np.float32)
    tbl = _make_tables(rng, B, pps, page, NP, lengths)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    ours = ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(tbl),
                                      torch.from_numpy(lengths),
                                      window=window, softcap=softcap)
    pallas = ref_ops.paged_decode_attention(
        jq, jk, jv, jnp.asarray(tbl), jnp.asarray(lengths), window=window,
        softcap=softcap)
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL
    assert ours.shape == (B, 1, KV * G, D) and ours.dtype == tq.dtype
    _close(ours, pallas, atol)
    oracle = jref.paged_attention_ref(
        jq[:, 0].reshape(B, KV, G, D), jk, jv, jnp.asarray(tbl),
        jnp.asarray(lengths), window=window, softcap=softcap)
    _close(ours[:, 0].reshape(B, KV, G, D), oracle, atol)
    assert (ours[2] == 0).all()                    # length-0 row: zeros


PREFILL_CASES = [
    # G, D, page, C, window, softcap, dtype
    (2, 32, 8, 5, None, None, "f32"),
    (7, 64, 16, 4, None, None, "bf16"),
    (2, 64, 8, 6, 7, None, "f32"),     # window shorter than the context
    (7, 32, 8, 3, None, 30.0, "bf16"),  # softcap
    (2, 32, 16, 7, 9, 50.0, "f32"),    # window + softcap
]


@pytest.mark.parametrize("G,D,page,C,window,softcap,dtype", PREFILL_CASES)
def test_prefill_matches_reference(G, D, page, C, window, softcap, dtype):
    rng = np.random.default_rng(G * 1000 + D + page + C)
    B, KV, pps = 4, 2, 4
    NP = B * pps + 1
    # start_pos > 0 mid-page, full, partial and q_len == 0 rows
    starts = np.array([0, page + 3, 2 * page - 1, 5], np.int32)
    q_lens = np.array([C, C - 2, 0, 1], np.int32)
    q = rng.standard_normal((B, C, KV * G, D)).astype(np.float32)
    kp = rng.standard_normal((NP, page, KV, D)).astype(np.float32)
    vp = rng.standard_normal((NP, page, KV, D)).astype(np.float32)
    tbl = _make_tables(rng, B, pps, page, NP, starts + q_lens)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    ours = ops.paged_prefill_attention(
        tq, tk, tv, torch.from_numpy(tbl), torch.from_numpy(starts),
        torch.from_numpy(q_lens), window=window, softcap=softcap)
    pallas = ref_ops.paged_prefill_attention(
        jq, jk, jv, jnp.asarray(tbl), jnp.asarray(starts),
        jnp.asarray(q_lens), window=window, softcap=softcap)
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL
    assert ours.shape == (B, C, KV * G, D) and ours.dtype == tq.dtype
    _close(ours, pallas, atol)
    oracle = jref.paged_prefill_ref(
        jq.reshape(B, C, KV, G, D), jk, jv, jnp.asarray(tbl),
        jnp.asarray(starts), jnp.asarray(q_lens), window=window,
        softcap=softcap)
    _close(ours.reshape(B, C, KV, G, D), oracle, atol)
    assert (ours[2] == 0).all()                    # q_len == 0 row
    assert (ours[1, C - 2:] == 0).all()            # padding tokens


def test_kernel_layout_plain_versions_fold_like_ops():
    """The kernel-layout plain versions are the oracles under the head
    folding ``ops`` does (decode (B,KV,G,D); prefill row c*G+g)."""
    rng = np.random.default_rng(7)
    B, C, KV, G, D, NP, page, pps = 2, 3, 2, 7, 16, 9, 8, 4
    q = torch.from_numpy(rng.standard_normal((B, C, KV, G, D)).astype(
        np.float32))
    kp = torch.from_numpy(rng.standard_normal((NP, page, KV, D)).astype(
        np.float32))
    vp = torch.from_numpy(rng.standard_normal((NP, page, KV, D)).astype(
        np.float32))
    tbl = torch.from_numpy(_make_tables(rng, B, pps, page, NP, [20, 11]))
    starts = torch.tensor([17, 0], dtype=torch.int32)
    qlens = torch.tensor([3, 2], dtype=torch.int32)
    folded = q.permute(0, 2, 1, 3, 4).reshape(B, KV, C * G, D)
    out = pp.paged_prefill_plain(folded, kp, vp, tbl, starts, qlens, group=G)
    want = tref.paged_prefill_ref(q, kp, vp, tbl, starts, qlens)
    torch.testing.assert_close(
        out, want.permute(0, 2, 1, 3, 4).reshape(B, KV, C * G, D))
    lens = torch.tensor([20, 1], dtype=torch.int32)
    torch.testing.assert_close(
        pa.paged_attention_plain(q[:, 0], kp, vp, tbl, lens),
        tref.paged_attention_ref(q[:, 0], kp, vp, tbl, lens))


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros((1, 1, 2, 8), device="meta")
    pages = torch.zeros((2, 8, 1, 8), device="meta")
    tbl = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    lens = torch.ones((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_attention(q, pages, pages, tbl, lens)
    with pytest.raises(ValueError, match="no kernel"):
        pp.paged_prefill(q, pages, pages, tbl, lens, lens, group=2)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("G,D,page,window,softcap",
                         [(7, 64, 16, None, None), (2, 288, 16, 40, 50.0),
                          (2, 32, 8, 11, 30.0)])
def test_cuda_kernels_match_plain(cuda, G, D, page, window, softcap):
    rng = np.random.default_rng(0)
    B, KV, pps, C = 4, 2, 6, 8
    NP = B * pps + 1
    bf = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16,
                                 device=cuda)
    kp, vp = bf(NP, page, KV, D), bf(NP, page, KV, D)
    lengths = np.array([1, page * pps, 0, 2 * page + 3], np.int32)
    tbl = torch.from_numpy(_make_tables(rng, B, pps, page, NP,
                                        lengths)).to(cuda)
    lens = torch.from_numpy(lengths).to(cuda)
    q = bf(B, KV, G, D)
    launches = pa.paged_attention.launches
    got = pa.paged_attention(q, kp, vp, tbl, lens, window=window,
                             softcap=softcap)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == launches + 1
    want = pa.paged_attention_plain(q, kp, vp, tbl, lens, window=window,
                                    softcap=softcap)
    assert (got.float() - want.float()).abs().max().item() <= BF16_ATOL
    starts = torch.tensor([0, page + 3, 7, 2 * page], dtype=torch.int32,
                          device=cuda)
    qlens = torch.tensor([C, 3, 0, 1], dtype=torch.int32, device=cuda)
    q2 = bf(B, KV, C * G, D)
    got = pp.paged_prefill(q2, kp, vp, tbl, starts, qlens, group=G,
                           window=window, softcap=softcap)
    torch.cuda.synchronize()
    want = pp.paged_prefill_plain(q2, kp, vp, tbl, starts, qlens, group=G,
                                  window=window, softcap=softcap)
    assert (got.float() - want.float()).abs().max().item() <= BF16_ATOL
    assert (got[2] == 0).all()


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_wrong_inputs(cuda):
    q = torch.zeros((1, 2, 2, 8), dtype=torch.float32, device=cuda)
    pages = torch.zeros((2, 8, 2, 8), dtype=torch.bfloat16, device=cuda)
    tbl = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pa.paged_attention(q, pages, pages, tbl, lens)
    with pytest.raises(ValueError):
        pa.paged_attention(q.bfloat16(), pages, pages, tbl.cpu(), lens)
