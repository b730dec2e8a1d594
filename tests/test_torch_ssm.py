"""Mamba2 / SSD in the port against the reference, on the same numpy
inputs (and, for whole blocks, the same bridged weights): the SSD scan's
plain version against the Pallas kernel in interpret mode and against
``ssd_chunked`` (ragged S, initial and final state, G > 1), the decode
recurrence and the causal conv with state, the scan's autograd Function
against autograd through its plain version, and ``mamba2_block`` in both
branches.

Tolerances: the Pallas comparisons use ``tests/test_kernels.py``'s (1e-3
in f32, where the chunked and the kernel forms sum in another order;
5e-2 with bf16 inputs); ``ssd_chunked``, the recurrence and the conv in
f32 at atol 1e-5 and rtol 1e-5 (the same algorithm, only the summation
order differs; outputs reach ~10 with an initial state, observed 2e-6
relative); gradients at 1e-5 (f32); a block in bf16 at one bf16
ulp (rtol 8e-3) and in f32 at 1e-5.  The CUDA kernel itself is held
against the plain version by the ``gpu`` test at the end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs import get_smoke_config
from repro.kernels import ops as ref_ops
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.models import ssm as JS
from repro.models import transformer as T
from repro_torch import bridge
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

PALLAS_TOL = {"f32": 1e-3, "bf16": 5e-2}
F32_ATOL = 1e-5
BF16_RTOL = 8e-3


def _inputs(seed, b, S, H, P, G, N):
    """x, dt (softplus of a normal), A (-exp of a normal), B, C as numpy
    f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, S, H, P)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(
                np.float32),
            -np.exp(rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


PALLAS_CASES = [
    # BH, S, P, N, chunk, dtype
    (4, 64, 32, 16, 16, "f32"),
    (2, 64, 64, 128, 64, "f32"),       # the full config's P and N
    (1, 96, 32, 16, 32, "f32"),
    (2, 64, 32, 16, 16, "bf16"),
]


@pytest.mark.parametrize("BH,S,P,N,chunk,dtype", PALLAS_CASES)
def test_plain_ssd_matches_pallas_kernel(BH, S, P, N, chunk, dtype):
    """The kernel's plain version (model layout) against the Pallas kernel
    (its (BH, S, P) layout, interpret mode): BH heads, each its own
    group, as one batch row."""
    x, dt, A, B, C = _inputs(BH + S + N, 1, S, BH, P, BH, N)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    fold = lambda a: jnp.asarray(a[0].swapaxes(0, 1), jdt)   # (BH, S, .)
    want = pallas_ssd_scan(fold(x), jnp.asarray(dt[0].T), jnp.asarray(A),
                           fold(B), fold(C), chunk, interpret=True)
    tx, tB, tC = _t(x, B, C, dtype=tdt)
    tdt_, tA = _t(dt, A)
    got = ssd.ssd_scan(tx, tdt_, tA, tB, tC, chunk)
    assert got.shape == (1, S, BH, P) and got.dtype == tdt
    np.testing.assert_allclose(
        got[0].float().numpy().swapaxes(0, 1),
        np.asarray(want).astype(np.float32), atol=PALLAS_TOL[dtype])


def test_ops_ssd_with_groups_matches_reference_ops():
    """``ops.ssd`` with G = 2 (heads read their group's B and C) against
    the reference's ``ops.ssd`` (Pallas, interpret mode)."""
    x, dt, A, B, C = _inputs(1, 2, 64, 4, 32, 2, 16)
    want = ref_ops.ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk=16,
                       interpret=True)
    got = ops.ssd(*_t(x, dt, A, B, C), chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_TOL["f32"])


@pytest.mark.parametrize("S,chunk,with_state", [
    (37, 8, False),          # S not a chunk multiple: padded with dt = 0
    (37, 16, True),          # ... with an initial state
    (5, 16, True),           # S shorter than a chunk: L = S
])
def test_ssd_chunked_matches_reference(S, chunk, with_state):
    x, dt, A, B, C = _inputs(S + chunk, 2, S, 4, 8, 2, 16)
    h0 = (np.random.default_rng(9).standard_normal((2, 4, 16, 8)).astype(
        np.float32) if with_state else None)
    want_y, want_h = JS.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, B, C)), chunk,
        initial_state=None if h0 is None else jnp.asarray(h0))
    got_y, got_h = PS.ssd_chunked(
        *_t(x, dt, A, B, C), chunk,
        initial_state=None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=F32_ATOL, rtol=F32_ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=F32_ATOL, rtol=F32_ATOL)
    # ops.ssd pads the same way (zero initial state)
    if not with_state:
        np.testing.assert_allclose(ops.ssd(*_t(x, dt, A, B, C),
                                           chunk=chunk).numpy(),
                                   np.asarray(want_y), atol=F32_ATOL)


def test_decode_step_and_conv_match_reference():
    rng = np.random.default_rng(4)
    b, H, P, G, N, w, Cd = 3, 4, 8, 2, 16, 4, 24
    state = rng.standard_normal((b, H, N, P)).astype(np.float32)
    xs = rng.standard_normal((b, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, G, N)).astype(np.float32)
              for _ in range(2))
    wy, wh = JS.ssd_decode_step(*map(jnp.asarray, (state, xs, dt, A, Bm,
                                                   Cm)))
    gy, gh = PS.ssd_decode_step(*_t(state, xs, dt, A, Bm, Cm))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=F32_ATOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=F32_ATOL)

    xBC = rng.standard_normal((b, 5, Cd)).astype(np.float32)
    cw = rng.standard_normal((w, Cd)).astype(np.float32)
    cb = rng.standard_normal(Cd).astype(np.float32)
    cs = rng.standard_normal((b, w - 1, Cd)).astype(np.float32)
    for st in (None, cs):
        wo, ws = JS.causal_conv1d(jnp.asarray(xBC), jnp.asarray(cw),
                                  jnp.asarray(cb),
                                  None if st is None else jnp.asarray(st))
        go, gs = PS.causal_conv1d(*_t(xBC, cw, cb),
                                  None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), atol=F32_ATOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=F32_ATOL)
    # bf16 in: the conv sums in f32 and rounds once
    wo, _ = JS.causal_conv1d(jnp.asarray(xBC, jnp.bfloat16),
                             jnp.asarray(cw), jnp.asarray(cb))
    go, _ = PS.causal_conv1d(torch.from_numpy(xBC).bfloat16(), *_t(cw, cb))
    assert go.dtype == torch.bfloat16
    np.testing.assert_allclose(go.float().numpy(),
                               np.asarray(wo).astype(np.float32),
                               rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.parametrize("S,chunk,G", [(32, 8, 1), (29, 16, 2)])
def test_ssd_function_grads_match_autograd(S, chunk, G):
    """The autograd Function (plain forward here, the plain version's VJP
    as its backward) against autograd through ``ssd_chunked``, including
    a ragged S through ``ops.ssd``'s padding."""
    arrays = _inputs(S * G, 2, S, 4, 8, G, 16)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, S, 4, 8)).astype(np.float32))

    def leaves():
        return [t.requires_grad_(True) for t in _t(*arrays)]

    ins = leaves()
    got = torch.autograd.grad(ops.ssd(*ins, chunk=chunk), ins, dy)
    ins = leaves()
    want = torch.autograd.grad(PS.ssd_chunked(*ins, chunk)[0], ins, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=F32_ATOL, rtol=0)


def test_ssd_exp_overflow_above_the_diagonal_gives_finite_grads():
    """|dt * A| summing past ~88 inside a chunk overflows exp(cum_i -
    cum_j) above the diagonal; the plain version selects before the exp,
    so its forward equals the reference's and its gradients stay finite
    (the reference's autodiff gives NaN there: ROADMAP Queue 3)."""
    x, dt, A, B, C = _inputs(3, 1, 16, 2, 4, 1, 4)
    dt[:] = 1.0
    A[:] = [-20.0, -1.0]
    want, _ = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 16)
    ins = [t.requires_grad_(True) for t in _t(x, dt, A, B, C)]
    y = ops.ssd(*ins, chunk=16)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=F32_ATOL)
    for g in torch.autograd.grad(y.sum(), ins):
        assert torch.isfinite(g).all()


@pytest.fixture(scope="module")
def mamba():
    cfg = get_smoke_config("mamba2-1.3b")
    params = jax.jit(T.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(params).items()}
    return cfg, port_smoke_config("mamba2-1.3b"), params, \
        bridge.from_flat(flat)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mamba2_block_matches_reference(mamba, dtype):
    """Layer 0's block, no-cache branch over 24 tokens (the SSD scan over
    two chunks) and the decode branch one token at a time from a zero
    cache, on bridged weights."""
    cfg, pcfg, params, pparams = mamba
    cfg, pcfg = cfg.with_(dtype=dtype), pcfg.with_(dtype=dtype)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["mamba"])
    tp = PT._index(pparams["layers"]["mamba"], 0)
    x = (0.5 * np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model))).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))

    def close(ours, theirs):
        if dtype == "float32":
            np.testing.assert_allclose(ours.float().numpy(),
                                       np.asarray(theirs), atol=F32_ATOL)
        else:
            np.testing.assert_allclose(
                ours.float().numpy(), np.asarray(theirs).astype(np.float32),
                rtol=BF16_RTOL, atol=1e-6)

    want, _ = jax.jit(lambda p, x: JS.mamba2_block(p, cfg, x))(jp, jx)
    with torch.no_grad():
        got, none = PS.mamba2_block(tp, pcfg, tx)
    assert none is None and got.dtype == tx.dtype
    close(got, want)

    jc = JS.init_mamba2_cache(cfg, 2)
    tc = PS.init_mamba2_cache(pcfg, 2)
    step = jax.jit(lambda p, x, c: JS.mamba2_block(p, cfg, x, cache=c))
    for t in range(3):
        want, jc = step(jp, jx[:, t:t + 1], jc)
        with torch.no_grad():
            got, tc = PS.mamba2_block(tp, pcfg, tx[:, t:t + 1], cache=tc)
        close(got, want)
        close(tc["ssm"], jc["ssm"])
        close(tc["conv"], jc["conv"])


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,H,P,G,N,chunk,dtype", [
    (2, 64, 8, 32, 1, 16, 16, "f32"),        # the smoke config's shapes
    (1, 300, 4, 64, 2, 128, 256, "bf16"),    # G = 2, S ragged, full P, N
    (2, 512, 4, 64, 1, 128, 256, "bf16"),    # two chunks carry the state
    (8, 1024, 64, 64, 1, 64, 256, "bf16"),   # zamba2-1.2b's layers: N 64
])
def test_cuda_ssd_matches_plain(cuda, b, S, H, P, G, N, chunk, dtype):
    """The kernel's output through ``ops.ssd`` (padding included) and the
    gradients through the autograd Function against the plain version;
    output errors element by element relative to max(1, |plain|)."""
    arrays = _inputs(S, b, S, H, P, G, N)
    dt_ = torch.float32 if dtype == "f32" else torch.bfloat16
    x, B, C = (torch.from_numpy(a).to(cuda, dt_)
               for a in (arrays[0], arrays[3], arrays[4]))
    dtv, A = (torch.from_numpy(a).to(cuda) for a in arrays[1:3])
    tol = 1e-4 if dtype == "f32" else 2e-2
    launches = ssd.ssd_scan.launches
    got = ops.ssd(x, dtv, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == launches + 1
    want = PS.ssd_chunked(x, dtv, A, B, C, chunk)[0]
    scale = want.float().abs().clamp(min=1.0)
    assert ((got.float() - want.float()).abs() / scale).max().item() <= tol
    dy = torch.randn(got.shape, device=cuda, dtype=dt_)
    ins = [t.clone().requires_grad_(True) for t in (x, dtv, A, B, C)]
    g_got = torch.autograd.grad(ops.ssd(*ins, chunk=chunk), ins, dy)
    ins = [t.clone().requires_grad_(True) for t in (x, dtv, A, B, C)]
    g_want = torch.autograd.grad(PS.ssd_chunked(*ins, chunk)[0], ins, dy)
    for g, w in zip(g_got, g_want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, w.float().abs().max().item())


@pytest.mark.gpu
def test_cuda_ssd_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros((1, 32, 2, 64), dtype=torch.bfloat16, device=cuda)
    dt = torch.zeros((1, 32, 2), device=cuda)
    A = torch.zeros((2,), device=cuda)
    B = torch.zeros((1, 32, 1, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd.ssd_scan(x, dt, A, B, B, 24)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x, dt.bfloat16(), A, B, B, 16)
    with pytest.raises(ValueError, match="up to 128"):
        big = torch.zeros((1, 32, 1, 256), dtype=torch.bfloat16,
                          device=cuda)
        ssd.ssd_scan(x, dt, A, big, big, 16)
