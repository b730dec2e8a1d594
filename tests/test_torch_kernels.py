"""Attention kernels (paged decode, paged prefill, flash) and RMSNorm: the
port's plain versions, through ``repro_torch.kernels.ops``, against the
reference's Pallas kernels (in interpret mode off-TPU, as
``repro.kernels.ops`` chooses) and against ``repro.kernels.ref``, on the
same numpy inputs; and the PyTorch backwards of flash attention and
RMSNorm against autograd through their plain versions.  (The SSD scan's
are in ``test_torch_ssm.py``.)

Tolerances: atol 1e-5 with f32 inputs (both sides compute in f32; only
the summation order differs); atol 2e-2 with bf16 inputs (outputs are
rounded to bf16: one bf16 ulp at |x| ~ 4); RMSNorm at
``tests/test_kernels.py``'s 1e-5 (f32) and 5e-2 (bf16 out).  The CUDA
kernels themselves are held against the plain versions by the ``gpu``
tests at the end, which run on a machine with a card (``python -m pytest
-m gpu tests/``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_prefill as pp
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as ssd

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
    """A tensor on a device with no kernel (a stand-in on ``xpu``) is
    refused; ``meta`` tensors take the accounting route (outputs of the
    kernel's shapes, no launch) since the dry-run reads it."""
    from types import SimpleNamespace
    from repro_torch.kernels import _build

    def elsewhere(t):
        return SimpleNamespace(device=torch.device("xpu"), shape=t.shape,
                               dtype=t.dtype)

    q = torch.zeros((1, 1, 2, 8), device="meta")
    pages = torch.zeros((2, 8, 1, 8), device="meta")
    tbl = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    lens = torch.ones((1,), dtype=torch.int32, device="meta")
    x = torch.zeros((1, 4, 2, 8), device="meta")
    k8 = torch.zeros((1, 4, 1, 8), dtype=torch.int8, device="meta")
    xq, xx = elsewhere(q), elsewhere(x)
    with pytest.raises(ValueError, match="no kernel"):
        pa.paged_attention(xq, pages, pages, tbl, lens)
    with pytest.raises(ValueError, match="no kernel"):
        pp.paged_prefill(xq, pages, pages, tbl, lens, lens, group=2)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(xq, pages[:1], pages[:1])
    with pytest.raises(ValueError, match="no kernel"):
        rn.rmsnorm(xq, torch.zeros((8,), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ssd.ssd_scan(xx, x[..., 0], x[0, 0, :, 0], x, x, 4)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention_int8kv(xq, k8, k8[..., 0], k8, k8[..., 0], lens,
                                  lens)
    launches = _build.launch_counts()
    got = [pa.paged_attention(q, pages, pages, tbl, lens),
           pp.paged_prefill(q, pages, pages, tbl, lens, lens, group=2),
           fa.flash_attention(q, pages[:1], pages[:1])[0],
           rn.rmsnorm(q, torch.zeros((8,), device="meta")),
           ssd.ssd_scan(x, torch.zeros((1, 4, 2), device="meta"),
                        torch.zeros((2,), device="meta"),
                        torch.zeros((1, 4, 1, 8), device="meta"),
                        torch.zeros((1, 4, 1, 8), device="meta"), 4),
           fa.flash_attention_int8kv(
               q, k8, torch.zeros((1, 4, 1), device="meta"), k8,
               torch.zeros((1, 4, 1), device="meta"), lens, lens)]
    assert all(t.device.type == "meta" for t in got)
    assert [tuple(t.shape) for t in got] == [(1, 1, 2, 8)] * 4 + [
        (1, 4, 2, 8), (1, 1, 2, 8)]
    assert _build.launch_counts() == launches


# ---------------------------------------------------------------------------
# RMSNorm: plain version and PyTorch backward
# ---------------------------------------------------------------------------

RMSNORM_CASES = [
    # shape, in dtype, out dtype
    ((64, 128), "f32", "f32"),
    ((3, 37, 128), "bf16", "bf16"),      # 111 rows
    ((2, 7, 11, 256), "f32", "f32"),
    ((1, 512), "bf16", "bf16"),
    ((300, 896), "bf16", "bf16"),        # qwen2 width, 300 rows: the last
                                         # 256-row tile partial
    ((2, 150, 2048), "f32", "bf16"),     # the unrounded residual in
]


@pytest.mark.parametrize("shape,din,dout", RMSNORM_CASES)
def test_rmsnorm_plain_matches_pallas(shape, din, dout):
    rng = np.random.default_rng(shape[-1] + len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    s = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jx, tx = _pair(x, din)
    want = pallas_rmsnorm(jx, jnp.asarray(s), interpret=True)
    if dout != din:                  # the Pallas kernel writes x's dtype
        want = want.astype(jnp.bfloat16)
    got = ops.rmsnorm(tx, torch.from_numpy(s),
                      out_dtype=getattr(torch, dict(f32="float32",
                                                    bf16="bfloat16")[dout]))
    assert got.shape == shape
    assert got.dtype == (torch.float32 if dout == "f32" else torch.bfloat16)
    _close(got, want, 1e-5 if dout == "f32" else 5e-2)
    _close(got, jref.rmsnorm_ref(jx, jnp.asarray(s)).astype(want.dtype),
           1e-5 if dout == "f32" else 5e-2)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_matches_autograd(out_dtype):
    """The autograd Function (plain forward here, PyTorch backward)
    against torch autograd through the plain version, f32 at 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 96)).astype(np.float32)
    s = (0.1 * rng.standard_normal(96)).astype(np.float32)
    dy = torch.from_numpy(rng.standard_normal((3, 7, 96)).astype(
        np.float32)).to(out_dtype)

    def leaves():
        return [torch.from_numpy(a).requires_grad_(True) for a in (x, s)]

    ins = leaves()
    got = torch.autograd.grad(ops.rmsnorm(ins[0], ins[1], out_dtype=out_dtype),
                              ins, dy)
    ins = leaves()
    want = torch.autograd.grad(
        rn.rmsnorm_ref(ins[0], ins[1], out_dtype=out_dtype), ins, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, atol=F32_ATOL, rtol=F32_ATOL)


# ---------------------------------------------------------------------------
# flash attention: plain version and PyTorch backward
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # B, S, H, KV, D, causal, window, softcap, dtype
    (2, 37, 4, 2, 64, True, None, None, "f32"),   # GQA, S not a block mult.
    (1, 150, 4, 4, 288, True, 40, 50.0, "f32"),   # gemma2 head dim, S > 128
    (2, 20, 2, 1, 32, False, 7, None, "f32"),     # bidirectional window
    (1, 130, 6, 2, 64, True, None, 30.0, "bf16"),  # softcap, G = 3
    (2, 64, 2, 2, 288, True, 16, 50.0, "bf16"),   # window + softcap, D 288
]


def _gqa_fold(a, G):
    """numpy (B, S, N, D) -> (B * N * G, S, D), each head repeated G times
    (the reference's ``ops`` fold)."""
    B, S, N, D = a.shape
    return np.repeat(a.transpose(0, 2, 1, 3)[:, :, None], G, axis=2).reshape(
        B * N * G, S, D)


def _masked_lse(q, k, causal, window, softcap):
    """float64 logsumexp of each row's masked scores, (BH, Sq)."""
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if softcap is not None:
        s = softcap * np.tanh(s / softcap)
    qp, kp = np.arange(q.shape[1])[:, None], np.arange(k.shape[1])[None]
    mask = np.ones_like(s[0], bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    s = np.where(mask[None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window,softcap,dtype",
                         FLASH_CASES)
def test_flash_plain_matches_reference(B, S, H, KV, D, causal, window,
                                       softcap, dtype):
    rng = np.random.default_rng(B * 1000 + S + D)
    G = H // KV
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL
    kw = dict(causal=causal, window=window, softcap=softcap)
    # the oracle's layout: (BH, S, D) with K/V repeated per group
    qf = q.reshape(B, S, KV, G, D).transpose(0, 2, 3, 1, 4).reshape(
        B * H, S, D)
    kf, vf = _gqa_fold(k, G), _gqa_fold(v, G)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (qf, kf, vf))
    ours, lse = tref.attention_ref(tq, tk, tv, return_lse=True, **kw)
    assert ours.dtype == tq.dtype and lse.dtype == torch.float32
    _close(ours, jref.attention_ref(jq, jk, jv, **kw), atol)
    _close(ours, jfa.flash_attention(jq, jk, jv, interpret=True, **kw),
           atol)
    np.testing.assert_allclose(
        lse.numpy(), _masked_lse(tq.float().numpy(), tk.float().numpy(),
                                 causal, window, softcap),
        rtol=1e-5, atol=1e-5)
    # the model-layout wrapper against the reference's ops wrapper
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out = ops.mha_flash_attention(tq, tk, tv, **kw)
    assert out.shape == (B, S, H, D) and out.dtype == tq.dtype
    _close(out, ref_ops.mha_flash_attention(jq, jk, jv, **kw), atol)


def test_flash_rows_without_a_key_are_zero():
    """A row no key can reach writes zeros and has lse -inf (the kernels'
    semantics; the softmax itself would average the masked values)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(
        np.float32)) for _ in range(3))
    # causal, window 1 (each row sees only its own position), 3 keys:
    # rows 3 and 4 reach none
    out, lse = tref.attention_ref(q, k[:, :3], v[:, :3], causal=True,
                                  window=1, return_lse=True)
    assert (out[:, 3:] == 0).all() and torch.isinf(lse[:, 3:]).all()
    assert (lse[:, 3:] < 0).all() and torch.isfinite(lse[:, :3]).all()
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q[None], k[None], v[None], window=0)


@pytest.mark.parametrize("causal,window,softcap,G,q_chunk", [
    (True, None, None, 2, 512),
    (True, 9, 50.0, 3, 16),         # several query chunks, window bounds
    (False, 5, None, 1, 7),         # bidirectional, ragged last chunk
    (True, None, 30.0, 4, 13),
])
def test_flash_backward_matches_autograd(causal, window, softcap, G,
                                         q_chunk):
    """The autograd Function (plain forward here, PyTorch backward)
    against torch autograd through the plain version, f32 at 1e-5."""
    rng = np.random.default_rng(G + q_chunk)
    B, S, KV, D = 2, 40, 2, 32
    H = KV * G
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    dout = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32))
    kw = dict(causal=causal, window=window, softcap=softcap)

    def leaves():
        return [torch.from_numpy(a).requires_grad_(True) for a in arrays]

    ins = leaves()
    got = torch.autograd.grad(ops.mha_flash_attention(*ins, **kw), ins, dout)
    ins = leaves()
    want = torch.autograd.grad(fa.flash_attention_plain(*ins, **kw)[0], ins,
                               dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=F32_ATOL, rtol=0)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    _, lse = fa.flash_attention_plain(q, k, v, **kw)
    chunked = fa.flash_attention_bwd(q, k, v, lse, dout, q_chunk=q_chunk,
                                     **kw)
    for g, w in zip(chunked, want):
        torch.testing.assert_close(g, w, atol=F32_ATOL, rtol=0)


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
    # the split decode kernel keeps P in f32: element by element within
    # 2^-14 (|P| @ |V|) / l + one bf16 ulp of the plain output
    mix = pa.paged_attention_plain(q.float(), kp.float(), vp.float().abs(),
                                   tbl, lens, window=window, softcap=softcap)
    assert tref.rounding_bound_ratio(got, want, mix, pa.P_ROUNDING) <= 1.0
    assert (got[2] == 0).all()
    starts = torch.tensor([0, page + 3, 7, 2 * page], dtype=torch.int32,
                          device=cuda)
    qlens = torch.tensor([C, 3, 0, 1], dtype=torch.int32, device=cuda)
    q2 = bf(B, KV, C * G, D)
    got = pp.paged_prefill(q2, kp, vp, tbl, starts, qlens, group=G,
                           window=window, softcap=softcap)
    torch.cuda.synchronize()
    want = pp.paged_prefill_plain(q2, kp, vp, tbl, starts, qlens, group=G,
                                  window=window, softcap=softcap)
    # element by element within the bound of the routed kernel's rounding
    # of P (bf16 on the tensor cores, f32 on the CUDA cores); padding rows
    # (c >= q_len) and the q_len 0 row zeros
    mix = pp.paged_prefill_plain(q2.float(), kp.float(), vp.float().abs(),
                                 tbl, starts, qlens, group=G, window=window,
                                 softcap=softcap)
    assert tref.rounding_bound_ratio(got, want, mix,
                                     pp.p_rounding(q2.dtype, D)) <= 1.0
    for b, n in enumerate(qlens.tolist()):
        assert (got[b, :, n * G:] == 0).all()


# on the card only (the Pallas interpret run above would take minutes):
# zamba2-1.2b's shared attention block in training, MHA (G = 1)
CUDA_FLASH_CASES = [(8, 1024, 32, 32, 64, True, None, None, "bf16")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window,softcap,dtype",
                         FLASH_CASES + CUDA_FLASH_CASES)
def test_cuda_flash_matches_plain(cuda, B, S, H, KV, D, causal, window,
                                  softcap, dtype):
    """The flash kernel's output and lse, and the gradients through the
    autograd Function (kernel forward), against the plain version."""
    rng = np.random.default_rng(S + D)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    mk = lambda *s: torch.tensor(rng.standard_normal(s), dtype=dt,
                                 device=cuda)
    q, k, v = mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    launches = fa.flash_attention.launches
    n_tc = fa.flash_fwd_tensor_core.launches
    out, lse = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    assert (fa.flash_fwd_tensor_core.launches == n_tc + 1) == \
        fa.tensor_core_route(dt, D)
    want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
    atol = 1e-4 if dtype == "f32" else BF16_ATOL
    # element by element within the bound of the routed kernel's rounding
    # of P (bf16 on the tensor cores, f32 on the CUDA cores)
    mix = fa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                   **kw)[0]
    assert tref.rounding_bound_ratio(out, want, mix,
                                     fa.p_rounding(dt, D)) <= 1.0
    assert torch.equal(torch.isfinite(lse), torch.isfinite(want_lse))
    fin = torch.isfinite(want_lse)
    assert (lse[fin] - want_lse[fin]).abs().max().item() <= 1e-4
    dout = mk(B, S, H, D)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(ops.mha_flash_attention(*ins, **kw), ins, dout)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(fa.flash_attention_plain(*ins, **kw)[0], ins,
                              dout)
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= atol * max(1.0, r.float().abs().max().item())


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
    # any D up to 288 runs (padded to a multiple of 32); past it, raises
    kv = torch.zeros((1, 4, 1, 304), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="up to 288"):
        fa.flash_attention(kv, kv, kv)
    with pytest.raises(TypeError):
        fa.flash_attention(kv.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        qt = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16,
                         device=cuda).transpose(1, 2)
        fa.flash_attention(qt, qt, qt)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,din,dout", [
    (8, 896, torch.bfloat16, torch.bfloat16),
    (300, 2048, torch.float32, torch.bfloat16),
    (1000, 2304, torch.bfloat16, torch.float32),
    (129, 4096, torch.float32, torch.float32),
    (7, 100, torch.bfloat16, torch.bfloat16),     # d % 8 != 0: scalar path
])
def test_cuda_rmsnorm_matches_plain(cuda, rows, d, din, dout):
    """The kernel (any row count, all four dtype pairs, the vector and the
    scalar path) and the gradients through the Function against the plain
    version."""
    rng = np.random.default_rng(rows + d)
    x = torch.tensor(rng.standard_normal((rows, d)), dtype=din, device=cuda)
    s = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                     device=cuda)
    launches = rn.rmsnorm.launches
    got = rn.rmsnorm(x, s, out_dtype=dout)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == launches + 1
    want = rn.rmsnorm_ref(x, s, out_dtype=dout)
    # |y| reaches ~6, where one bf16 ulp is 3.1e-2 and a sum of squares in
    # another order can flip a rounding: error relative above |y| = 1
    atol = 1e-5 if dout == torch.float32 else BF16_ATOL

    def err(g, w):
        w = w.float()
        return ((g.float() - w).abs() / w.abs().clamp(min=1.0)).max().item()

    assert got.dtype == dout
    assert err(got, want) <= atol
    # rows that start one element off 16-byte alignment take the scalar
    # path
    xv = x.reshape(-1)[1:1 + (rows - 1) * d].view(rows - 1, d)
    got = rn.rmsnorm(xv, s, out_dtype=dout)
    assert err(got, rn.rmsnorm_ref(xv, s, out_dtype=dout)) <= atol
    dy = torch.randn((rows, d), dtype=dout, device=cuda)
    ins = [t.clone().requires_grad_(True) for t in (x, s)]
    g_got = torch.autograd.grad(ops.rmsnorm(*ins, out_dtype=dout), ins, dy)
    ins = [t.clone().requires_grad_(True) for t in (x, s)]
    g_want = torch.autograd.grad(rn.rmsnorm_ref(*ins, out_dtype=dout), ins,
                                 dy)
    for g, w in zip(g_got, g_want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, w.float().abs().max().item())
