"""Seeded traffic repeats exactly, and every seed serves the same sizes
in an order of its own."""
import numpy as np

from chipbench import core
from chipbench.traffic import serve_closed_loop as serve
from chipbench.traffic import train_steps as train
import chipbench_cpu as C


def _spec(name):
    return core.resolve(C.ROOT, core.benchmark(C.ROOT), name)[1]


def _sizes(spec, n, seed=2 ** 31 + 12345):
    return [serve.request_sizes(spec, seed, i) for i in range(n)]


def test_sizes_and_prompts_repeat_for_a_seed():
    spec = _spec("qwen2-0.5b.clients64")
    seed = 2 ** 31 + 12345
    assert _sizes(spec, 200) == _sizes(spec, 200)
    assert np.array_equal(serve.prompt_tokens(seed, 7, 100, 151936),
                          serve.prompt_tokens(seed, 7, 100, 151936))
    assert not np.array_equal(serve.prompt_tokens(seed, 7, 100, 151936),
                              serve.prompt_tokens(seed, 8, 100, 151936))
    assert not np.array_equal(serve.prompt_tokens(seed, 7, 100, 151936),
                              serve.prompt_tokens(seed + 1, 7, 100, 151936))


def test_every_block_serves_the_same_sizes_in_another_order():
    spec = _spec("qwen2-0.5b.clients64")
    n = spec["block"]
    a = _sizes(spec, 3 * n)
    blocks = [sorted(a[k * n:(k + 1) * n]) for k in range(3)]
    prompts = [sorted(p for p, _ in x) for x in blocks]
    outs = [sorted(o for _, o in x) for x in blocks]
    assert all(p == prompts[0] for p in prompts)
    assert all(o == outs[0] for o in outs)
    assert a[:n] != a[n:2 * n]
    other = _sizes(spec, 3 * n, seed=7)
    assert sorted(p for p, _ in other[:n]) == prompts[0]
    assert sorted(o for _, o in other[:n]) == outs[0]
    assert other[:n] != a[:n]


def test_size_grid_is_the_clipped_log_normal():
    g = serve.size_grid({"median": 128, "sigma": 0.5, "min": 64,
                         "max": 256}, 1024)
    assert g.min() == 64 and g.max() == 256
    assert abs(float(np.median(g)) - 128) <= 1
    assert np.all(np.diff(g) >= 0)


def test_first_requests_are_cut_to_a_spread_of_shares():
    spec = _spec("qwen2-0.5b.clients64")
    firsts = [serve.first_output(spec, c, 640)
              for c in range(spec["clients"])]
    assert min(firsts) >= 1 and max(firsts) <= spec["first_horizon"]
    assert firsts == sorted(firsts) and firsts[0] < firsts[-1]


def test_markov_batches_repeat_and_every_row_differs():
    a = train.markov_batches(307, 4, 32, 5, 99, 0.3)
    b = train.markov_batches(307, 4, 32, 5, 99, 0.3)
    assert np.array_equal(a, b) and a.shape == (5, 4, 32)
    rows = {r.tobytes() for r in a.reshape(-1, 32)}
    assert len(rows) == 20
    assert not np.array_equal(a, train.markov_batches(307, 4, 32, 5, 98,
                                                      0.3))
