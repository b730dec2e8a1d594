"""The 3DGAN's data in the port against the reference: calorimeter batches
bit for bit for several ``(seed, step, rank)``, per-rank sources, and the
sharded on-disk format read across packages in both directions (identical
batches, disjoint rank subsets, corruption detected)."""
import numpy as np
import pytest

from repro_torch.data import (CalorimeterSource, CalorimeterSpec,
                              ShardedDataset, generate_batch, write_dataset)


@pytest.mark.parametrize("seed,step,rank,batch", [
    (0, 0, 0, 4), (0, 7, 0, 3), (0, 7, 3, 3), (5, 2, 1, 2), (123, 10_000, 0, 5)])
def test_calorimeter_batches_are_the_reference_bit_for_bit(seed, step, rank,
                                                           batch):
    from repro.data import calorimeter as jcal
    got = generate_batch(CalorimeterSpec(seed=seed), batch, step, rank)
    want = jcal.generate_batch(jcal.CalorimeterSpec(seed=seed), batch, step,
                               rank)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert np.array_equal(got[k], want[k]), k
    assert got["images"].shape == (batch, 25, 25, 25, 1)


def test_calorimeter_sources_shard_like_the_reference():
    from repro.data import calorimeter as jcal
    for rank in range(4):
        got = CalorimeterSource(CalorimeterSpec(), 8, rank, 4).batch(3)
        want = jcal.CalorimeterSource(jcal.CalorimeterSpec(), 8, rank,
                                      4).batch(3)
        assert got["energies"].shape == (2,)
        for k in want:
            assert np.array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="multiple"):
        CalorimeterSource(CalorimeterSpec(), 6, 0, 4)


def _gen(steps=5, batch=24):
    for step in range(steps):
        yield generate_batch(CalorimeterSpec(), batch, step)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_shards_cross_read_with_identical_batches(tmp_path, writer):
    from repro.data import shards as jsh
    write = jsh.write_dataset if writer == "reference" else write_dataset
    path = write(tmp_path / "calo", _gen(), events_per_shard=32)
    for rank, world in ((0, 1), (0, 2), (1, 2)):
        port = ShardedDataset(path, rank=rank, world_size=world, seed=4)
        ref = jsh.ShardedDataset(path, rank=rank, world_size=world, seed=4)
        assert port.verify() and ref.verify()
        assert port.my_shards == ref.my_shards
        for epoch in (0, 1):
            got = list(port.epoch(epoch, batch_size=20))
            want = list(ref.epoch(epoch, batch_size=20))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in w:
                    assert np.array_equal(g[k], w[k]), (epoch, k)
    halves = [ShardedDataset(path, rank=r, world_size=2) for r in (0, 1)]
    assert not ({s["file"] for s in halves[0].my_shards}
                & {s["file"] for s in halves[1].my_shards})
    assert halves[0].local_events + halves[1].local_events == 5 * 24


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_shard_corruption_is_detected_by_both(tmp_path, writer):
    from repro.data import shards as jsh
    write = jsh.write_dataset if writer == "reference" else write_dataset
    path = write(tmp_path / "d", iter([{"x": np.arange(32, dtype=np.float32)}]),
                 events_per_shard=16)
    shard = path / ShardedDataset(path).my_shards[0]["file"]
    shard.write_bytes(shard.read_bytes()[:-1] + b"X")
    for ds in (ShardedDataset(path), jsh.ShardedDataset(path)):
        with pytest.raises(IOError, match="corrupt"):
            ds.verify()
