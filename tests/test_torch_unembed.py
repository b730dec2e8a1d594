"""The tied unembedding on the tensor cores (``kernels/unembed.py``).

On the CPU, which lacks ``torch.mm``'s ``out_dtype``, the Function's
products (``unembed._mm``) are emulated: f32 products of the upcast bf16
operands (``_f32_products``: exact products, f32 sums, as the tensor
cores' are), or those products summed in f64 (``_f64_products``):
- the three-term split is exact: hi + mid + lo == g, bit for bit, for
  every |g| from 2^-110 to 2^127, and within 5e-41 below (random bit
  patterns, softmax minus one-hot rows, negatives, zeros, subnormals;
  from bf16's largest value up, hi rounds to inf);
- ``TiedUnembed`` against today's chain, the f32 matmul of the cast
  operands, at a smoke vocabulary, with vocabularies that are and are
  not a multiple of a chunk's columns;
- the backward's dX and dW in f32, before their bf16 rounding, against
  the f64 products of the same values, and the same loop with mid and lo
  zeroed, or with a chunk left out, outside that bound;
- the routing: the CPU and f32 x keep the f32 matmul and count nothing;
  bf16 x on ``meta`` takes the Function, makes no f32 copy of the table
  and counts nothing; the Function counts a forward and a backward.

On the card (``gpu``): at qwen2-0.5b's table (151,936 x 896) and the
training cell's 32,736 rows, the logits against the f32 CUDA-core
matmul of the same bf16 values, the gradients against today's chain and,
in f32, against the f64 products (hi alone outside that bound), the peak
of forward plus backward against today's, the counter, and the split
kernel against its plain version, bit for bit.

Tolerances.  Two f32 sums of the same K exact products differ by at most
2 K 2^-23 times the sum of their magnitudes (``_sum_bound``: each sum
rounds toward zero at worst).  The gradients leave in bf16 (x's dtype;
the table's cast), as today's chain rounds them: two f32 values within
that bound, each rounded to bf16, differ by at most one bf16 unit (2^-7
of the value, at most) on top.  The f32 gradients against the f64
products: summed in f64 on the CPU, only each GEMM's f32 output and the
f32 sum over the chunks (dW: over its GEMMs of ``DW_ROWS`` rows) round,
(2 parts + 1) 2^-24 of the magnitudes' sum at most (``_f64_bound``); on
the card, where the tensor cores sum in f32, ``SQRT_K_UNITS`` sqrt(K)
2^-24 of it, K the contracted length (3 x vocabulary for dX, 3 x rows
for dW), and no more than today's f32 CUDA-core GEMMs of the same values
miss by.
"""
import functools

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import unembed as U
from repro_torch.models import modules

BF16_ULP = 2.0 ** -7            # one unit in the last place, at most
TINY = 2.0 ** -110              # exact from here up


def _sum_bound(a_abs, b_abs, k):
    """Largest gap between two f32 sums, in any order, of the same k
    exact products whose magnitudes are ``a_abs @ b_abs``: each sum
    within k 2^-23 of their total (rounding toward zero at worst, as the
    tensor cores may), the total taken in f32 and raised by its own
    rounding (k 2^-24 relative, the terms all positive)."""
    total = (a_abs.float() @ b_abs.float()) * (1 + k * 2.0 ** -24)
    return 2 * (k + 2) * 2.0 ** -23 * total


def _f32_chain(x, table):
    """Today's chain: the table cast to x's dtype, both upcast, an f32
    matmul."""
    return torch.matmul(x.float(), table.to(x.dtype).float().t())


def _f32_products(a, b):
    """``unembed._mm`` on the CPU: f32 products of the upcast bf16
    operands, exact as the tensor cores' are, summed in f32."""
    return torch.mm(a.float(), b.float())


def _f64_products(a, b):
    """The same products summed in f64, the sum rounded to f32 once."""
    return torch.mm(a.double(), b.double()).float()


def _f64_grads(x, wb, g):
    """dX and dW of the f32 cotangent g against bf16 x and table wb in
    f64 (exact products, f64 sums), and the sums of the products'
    magnitudes that bound each entry's rounding."""
    gd, xd, wd = g.double(), x.double(), wb.double()
    return (gd @ wd, gd.t() @ xd,
            gd.abs() @ wd.abs(), gd.abs().t() @ xd.abs())


def _f64_bound(mags, parts):
    """Largest gap of an f32 result, its ``parts`` (chunks, or GEMMs of
    dW's rows) each summed in f64 and rounded to f32 once, then added in
    f32, from the f64 sum of the same products: (2 parts + 1) 2^-24 of
    their magnitudes' sum (an f64 sum in any order is within 2^-40 of it
    at these sizes)."""
    return (2 * parts + 1) * 2.0 ** -24 * mags


def _hi_only(split):
    """``unembed_split`` with mid and lo zeroed: hi alone, a bf16
    cotangent (its launch counter copied: the kernel counts on it)."""
    @functools.wraps(split)
    def run(g, out):
        split(g, out)
        out[:, 1:].zero_()
        return out
    return run


def _split(g):
    out = torch.empty((g.shape[0], 3, g.shape[1]), dtype=torch.bfloat16,
                      device=g.device)
    return U.unembed_split(g, out)


def _values(n, seed):
    """f32 values of every kind the cotangent holds and more: random bit
    patterns (every exponent, both signs, subnormals, no inf or NaN),
    softmax minus one-hot rows over 1/rows, zeros."""
    gen = torch.Generator().manual_seed(seed)
    bits = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    vals = bits.view(torch.float32)
    vals = vals[torch.isfinite(vals)]
    logits = torch.randn((64, 307), generator=gen) * 8
    p = torch.softmax(logits, dim=-1)
    p[torch.arange(64), torch.randint(0, 307, (64,), generator=gen)] -= 1
    sub = torch.randint(1, 2 ** 23, (4096,), generator=gen,
                        dtype=torch.int32).view(torch.float32)
    return torch.cat([vals, (p / 2048).flatten(), -(p / 7).flatten(), sub,
                      -sub, torch.zeros(512)])


def test_split_is_exact():
    """hi + mid + lo == g bit for bit where 2^-110 <= |g| <= 2^127
    (summed in f64, exact for three bf16 values), within 5e-41 below;
    hi the nearest bf16 to g."""
    g = _values(1 << 21, 0)
    hi, mid, lo = _split(g[None])[0]
    total = hi.double() + mid.double() + lo.double()
    big = (g.abs() >= TINY) & (g.abs() <= 2.0 ** 127)
    assert big.sum() > 1_000_000 and (g.abs() < TINY).sum() > 10_000
    assert torch.equal(total[big], g.double()[big])
    small = g.abs() < TINY
    assert (total[small] - g.double()[small]).abs().max() < 5e-41
    assert torch.equal(hi, g.to(torch.bfloat16))


def test_split_of_a_strided_slice():
    """A slice of columns (the backward's chunk: row stride > cols) splits
    as the same values made contiguous."""
    g = torch.randn((12, 300)) * 1e-3
    whole = _split(g[:, 64:192].contiguous())
    assert torch.equal(_split(g[:, 64:192]), whole)


@pytest.mark.parametrize("rows,vocab,chunk", [
    (37, 307, 64),       # vocabulary not a multiple of the chunk
    (64, 256, 128),      # a multiple (two chunks)
    (5, 1000, None),     # one chunk (CHUNK_BYTES as shipped)
])
def _smoke(monkeypatch, rows, vocab, chunk, dw_rows, d=64):
    """x (bf16), the f32 table and the cotangent (softmax minus one-hot
    over the rows) at a smoke size; a chunk of ``chunk`` columns, dW
    summed ``dw_rows`` rows a GEMM."""
    if chunk is not None:
        monkeypatch.setattr(U, "CHUNK_BYTES", (6 * rows + 8 * d) * chunk)
        assert U.chunk_cols(rows, d) == chunk
    if dw_rows is not None:
        monkeypatch.setattr(U, "DW_ROWS", dw_rows)
    gen = torch.Generator().manual_seed(rows)
    x0 = torch.randn((rows, d), generator=gen).to(torch.bfloat16)
    w0 = torch.randn((vocab, d), generator=gen) * 0.05
    g = torch.softmax(torch.randn((rows, vocab), generator=gen) * 4, -1)
    g[torch.arange(rows), torch.randint(0, vocab, (rows,),
                                         generator=gen)] -= 1
    return x0, w0, g / rows


SMOKE = [
    (37, 307, 64, 16),       # vocabulary not a multiple of the chunk;
                             # dW over 16 + 16 + 5 rows
    (64, 256, 128, None),    # a multiple (two chunks)
    (5, 1000, None, None),   # one chunk (CHUNK_BYTES as shipped)
]


@pytest.mark.parametrize("rows,vocab,chunk,dw_rows", SMOKE)
def test_function_against_todays_chain(monkeypatch, rows, vocab, chunk,
                                       dw_rows):
    """Logits, dX and dW of ``TiedUnembed`` (products emulated exactly on
    the CPU) against the f32 chain: logits within ``_sum_bound`` over
    K = d; dX and dW after their bf16 rounding within one bf16 unit
    plus the sum-order bound (K = 3 x vocabulary for dX, 3 x rows for
    dW, the three terms' products)."""
    monkeypatch.setattr(U, "_mm", _f32_products)
    d = 64
    x0, w0, g = _smoke(monkeypatch, rows, vocab, chunk, dw_rows, d)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = U.TiedUnembed.apply(x, w.to(torch.bfloat16))
    y.backward(g)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    yr = _f32_chain(xr, wr)
    yr.backward(g)
    wb = w0.to(torch.bfloat16).float()
    assert y.dtype == torch.float32 and y.shape == yr.shape
    assert ((y - yr).abs().double()
            <= _sum_bound(x0.float().abs(), wb.abs().t(), d)).all()
    assert x.grad.dtype == xr.grad.dtype == torch.bfloat16
    assert w.grad.dtype == wr.grad.dtype == torch.float32
    for got, want, bound in (
            (x.grad, xr.grad, _sum_bound(g.abs(), wb.abs(), 3 * vocab)),
            (w.grad, wr.grad,
             _sum_bound(g.abs().t(), x0.float().abs(), 3 * rows))):
        gap = (got.double() - want.double()).abs()
        assert (gap <= BF16_ULP * want.double().abs()
                + (1 + BF16_ULP) * bound).all()


@pytest.mark.parametrize("rows,vocab,chunk,dw_rows", SMOKE)
def test_backward_products_in_f32(monkeypatch, rows, vocab, chunk,
                                  dw_rows):
    """dX and dW in f32, before their bf16 rounding, with the products
    summed in f64: within ``_f64_bound`` of the f64 products of the same
    values (dX over the chunks, dW over its GEMMs of ``DW_ROWS`` rows).
    The same loop with mid and lo zeroed (hi alone), and, where there are
    two chunks or more, with the second chunk's terms zeroed, must each
    land outside it somewhere."""
    monkeypatch.setattr(U, "_mm", _f64_products)
    x0, w0, g = _smoke(monkeypatch, rows, vocab, chunk, dw_rows)
    wb = w0.to(torch.bfloat16)
    chunks = -(-vocab // U.chunk_cols(rows, x0.shape[1]))
    blocks = -(-rows // U.DW_ROWS)
    dx_want, dw_want, dx_mag, dw_mag = _f64_grads(x0, wb, g)

    def worst(split):
        monkeypatch.setattr(U, "unembed_split", split)
        dw = torch.empty(wb.shape, dtype=torch.float32)
        dx = U.backward_products(x0, wb, g, dw)
        assert dx.dtype == torch.float32
        return max(((dx.double() - dx_want).abs()
                    / _f64_bound(dx_mag, chunks)).max().item(),
                   ((dw.double() - dw_want).abs()
                    / _f64_bound(dw_mag, blocks)).max().item())

    split = U.unembed_split
    assert worst(split) <= 1.0
    assert worst(_hi_only(split)) > 1.0
    if chunks > 1:
        calls = []

        @functools.wraps(split)
        def drop_second(gc, out):
            calls.append(1)
            split(gc, out)
            return out.zero_() if len(calls) == 2 else out
        assert worst(drop_second) > 1.0


def test_three_dim_input(monkeypatch):
    """(B, S, d) x gives (B, S, V) logits and a (B, S, d) gradient."""
    monkeypatch.setattr(U, "_mm", _f32_products)
    x = torch.randn((2, 5, 32)).to(torch.bfloat16).requires_grad_()
    w = torch.randn((70, 32)).to(torch.bfloat16).requires_grad_()
    y = U.TiedUnembed.apply(x, w)
    assert y.shape == (2, 5, 70)
    y.sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


class _Made(torch.utils._python_dispatch.TorchDispatchMode):
    """(dtype, shape) of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((t.dtype, tuple(t.shape)))
        return out


def test_routing(monkeypatch):
    """The CPU (bf16 or f32 x) and f32 x on ``meta`` keep the f32 matmul
    and count nothing; bf16 x on ``meta`` takes ``TiedUnembed``, makes
    no f32 copy of the table in the forward, allocates the backward's
    gradients in their dtypes, adds the split's cost to
    ``_build.meta_cost`` and counts nothing; the Function on the CPU
    counts 1 a forward and 1 a backward."""
    assert _build.counters["unembed_tensor_core"] is U.unembed_tensor_core
    V, d = 96, 32
    start = U.unembed_tensor_core.launches
    p = {"table": torch.randn((V, d), requires_grad=True)}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((3, 4, d)).to(dt).requires_grad_()
        y = modules.unembed(p, x)
        assert type(y.grad_fn).__name__ != "TiedUnembedBackward"
        y.sum().backward()
    mp = {"table": torch.empty((V, d), device="meta", requires_grad=True)}
    xf = torch.empty((3, 4, d), device="meta", requires_grad=True)
    assert type(modules.unembed(mp, xf).grad_fn).__name__ != \
        "TiedUnembedBackward"
    assert U.unembed_tensor_core.launches == start
    xb = torch.empty((3, 4, d), dtype=torch.bfloat16, device="meta",
                     requires_grad=True)
    _build.meta_cost.reset()
    with _Made() as made:
        y = modules.unembed(mp, xb)
    assert type(y.grad_fn).__name__ == "TiedUnembedBackward"
    assert y.dtype == torch.float32 and y.shape == (3, 4, V)
    assert (torch.float32, (V, d)) not in made.made
    y.sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and mp["table"].grad.shape == \
        (V, d)
    assert _build.meta_cost.by_kernel["unembed_split"][1] == 10 * 12 * V
    assert U.unembed_tensor_core.launches == start
    monkeypatch.setattr(U, "_mm", _f32_products)
    xc = torch.randn((3, d)).to(torch.bfloat16).requires_grad_()
    U.TiedUnembed.apply(xc, p["table"].to(torch.bfloat16)).sum().backward()
    assert U.unembed_tensor_core.launches == start + 2


def test_chunk_cols():
    """A chunk's terms and its two f32 blocks of dW rows stay within
    ``CHUNK_BYTES``, its columns a multiple of ``COL_ALIGN``, at least
    one ``COL_ALIGN``."""
    for rows in (1, 1000, 32_736, 10 ** 9):
        for d in (64, 896, 4608):
            c = U.chunk_cols(rows, d)
            assert c % U.COL_ALIGN == 0 and c >= U.COL_ALIGN
            assert c == U.COL_ALIGN or (6 * rows + 8 * d) * c \
                <= U.CHUNK_BYTES


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

ROWS, VOCAB, D = 32 * 1023, 151_936, 896      # qwen2-0.5b's training cell
SQRT_K_UNITS = 2.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((ROWS, D), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((VOCAB, D), generator=gen, device=dev) * 0.02
    return x, w


def _cotangent(dev, logits):
    """softmax - one-hot over the rows, as the cross-entropy hands it."""
    g = torch.softmax(logits, dim=-1)
    g[torch.arange(ROWS, device=dev),
      torch.randint(0, VOCAB, (ROWS,), device=dev)] -= 1
    return g.div_(ROWS)


@pytest.mark.gpu
def test_cuda_split_kernel_bitwise(cuda):
    """The kernel equals the plain split bit for bit: the vector route on
    an aligned slice, the scalar route on an odd one, on the values of
    ``test_split_is_exact``."""
    g = _values(1 << 20, 1)[: 1024 * 900].reshape(1024, 900).to(cuda)
    for sl in (slice(64, 704), slice(3, 700)):
        got = _split(g[:, sl])
        want = U.unembed_split_plain(g[:, sl], torch.empty_like(got))
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_cuda_logits_and_gradients(cuda):
    """Logits within the sum-order bound of the f32 CUDA-core matmul of
    the same bf16 values (TF32 off); dX and dW within one bf16 unit plus
    that bound of today's chain; the counter counts 2."""
    assert not torch.backends.cuda.matmul.allow_tf32
    x0, w0 = _inputs(cuda)
    wb = w0.to(torch.bfloat16)
    start = U.unembed_tensor_core.launches
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    y = modules.unembed({"table": w}, x)
    assert U.unembed_tensor_core.launches == start + 1
    for r0 in range(0, ROWS, 4096):
        xs = x0[r0:r0 + 4096].float()
        want = xs @ wb.float().t()
        bound = _sum_bound(xs.abs(), wb.float().abs().t(), D).float()
        assert ((y[r0:r0 + 4096].detach() - want).abs() <= bound).all()
        del want, bound
    g = _cotangent(cuda, y.detach())
    y.backward(g)
    assert U.unembed_tensor_core.launches == start + 2
    del y
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    _f32_chain(xr, wr).backward(g)
    ga = g.abs()
    for got, want, bound in (
            (x.grad, xr.grad, _sum_bound(ga, wb.float().abs(), 3 * VOCAB)),
            (w.grad, wr.grad, _sum_bound(ga.t(), x0.float().abs(),
                                         3 * ROWS))):
        gap = (got.double() - want.double()).abs()
        assert (gap <= BF16_ULP * want.double().abs()
                + (1 + BF16_ULP) * bound).all()


@pytest.mark.gpu
def test_cuda_backward_products_in_f32(cuda, monkeypatch):
    """dX and dW in f32, before their bf16 rounding, at the cell's size
    against the f64 products of the same values (f64 GEMMs on the card):
    within ``SQRT_K_UNITS`` sqrt(K) 2^-24 of the products' magnitudes'
    sum, K = 3 x vocabulary for dX and 3 x rows for dW, and each no
    further off than today's f32 CUDA-core GEMMs (TF32 off) of the same
    values.  The same loop with mid and lo zeroed (hi alone) must land
    outside the bound."""
    x0, w0 = _inputs(cuda)
    wb = w0.to(torch.bfloat16)
    del w0
    with torch.no_grad():
        g = _cotangent(cuda, modules.unembed({"table": wb}, x0))
    xd, step = x0.double(), 8192
    dx_want = torch.zeros((ROWS, D), dtype=torch.float64, device=cuda)
    dx_mag = torch.zeros_like(dx_want)
    dw_want = torch.empty((VOCAB, D), dtype=torch.float64, device=cuda)
    dw_mag = torch.empty_like(dw_want)
    for v0 in range(0, VOCAB, step):
        gd, wd = g[:, v0:v0 + step].double(), wb[v0:v0 + step].double()
        dx_want += gd @ wd
        dw_want[v0:v0 + step] = gd.t() @ xd
        gd.abs_()
        dx_mag += gd @ wd.abs()
        dw_mag[v0:v0 + step] = gd.t() @ xd.abs()
        del gd, wd
    unit = SQRT_K_UNITS * 2.0 ** -24

    def ratios(dx, dw):
        rx = ((dx.double() - dx_want).abs()
              / (unit * (3 * VOCAB) ** 0.5 * dx_mag)).max().item()
        rw = max(((dw[v0:v0 + step].double() - dw_want[v0:v0 + step]).abs()
                  / (unit * (3 * ROWS) ** 0.5 * dw_mag[v0:v0 + step]))
                 .max().item() for v0 in range(0, VOCAB, step))
        return rx, rw

    def worst(split):
        monkeypatch.setattr(U, "unembed_split", split)
        dw = torch.empty((VOCAB, D), dtype=torch.float32, device=cuda)
        dx = U.backward_products(x0, wb, g, dw)
        assert dx.dtype == torch.float32
        return ratios(dx, dw)

    assert not torch.backends.cuda.matmul.allow_tf32
    today = ratios(g @ wb.float(), g.t() @ x0.float())
    split = U.unembed_split
    got, hi = worst(split), worst(_hi_only(split))
    print(f"f32 gradients over {SQRT_K_UNITS} sqrt(K) 2^-24 of the "
          f"magnitudes' sum (dX, dW): route {got[0]:.4f}, {got[1]:.4f}; "
          f"today's f32 GEMMs {today[0]:.4f}, {today[1]:.4f}; "
          f"hi alone {hi[0]:.4f}, {hi[1]:.4f}")
    assert max(got) <= 1.0
    assert got[0] <= today[0] and got[1] <= today[1]
    assert min(hi) > 1.0


@pytest.mark.gpu
def test_cuda_peak_within_two_gb_of_todays(cuda):
    """The peak of forward plus backward over what the inputs and the
    cotangent hold: the new route's at most today's + 2 GB."""
    x0, w0 = _inputs(cuda)
    g = _cotangent(cuda, torch.zeros((ROWS, VOCAB), device=cuda))

    def peak(fn):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        fn(x, w).backward(g)                      # warm-up
        x.grad = w.grad = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        fn(x, w).backward(g)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(cuda) - base

    today = peak(_f32_chain)
    new = peak(lambda x, w: modules.unembed({"table": w}, x))
    print(f"peak over inputs: today {today} B, tensor cores {new} B")
    assert new <= today + 2 * 10 ** 9
