"""The port's data pipeline against the JAX package's, bit for bit.

``repro_torch.data`` is the port's own numpy copy of ``repro.data``: the
same config, step and shard must give the same batch, so a checkpointed
step replays the same stream in either package.
"""

import numpy as np
import pytest

import repro.data as jd
import repro_torch.data as td


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (5, 0, 1), (7, 1, 2), (3, 3, 4)])
def test_synthetic_batch_at_equals_the_jax_packages(step, shard, n_shards):
    args = dict(seq_len=16, global_batch=8, vocab_size=100, seed=3)
    got = td.SyntheticLM(td.DataConfig(**args)).batch_at(step, shard, n_shards)
    _equal(got, jd.SyntheticLM(jd.DataConfig(**args)).batch_at(step, shard, n_shards))
    assert got["tokens"].shape == (8 // n_shards, 16)
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_synthetic_iterates_from_step_zero():
    ds = td.SyntheticLM(td.DataConfig(seq_len=4, global_batch=2, vocab_size=10))
    it = iter(ds)
    for step in range(3):
        _equal(next(it), ds.batch_at(step))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_token_file_dataset_equals_the_jax_packages(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(dtype).tofile(path)
    args = dict(seq_len=32, global_batch=4, vocab_size=60000, seed=1, kind="file",
                path=str(path))
    got_ds = td.TokenFileDataset(td.DataConfig(**args), dtype=dtype)
    want_ds = jd.TokenFileDataset(jd.DataConfig(**args), dtype=dtype)
    assert got_ds.n_windows == want_ds.n_windows
    for step, shard, n in ((0, 0, 1), (4, 1, 2)):
        _equal(got_ds.batch_at(step, shard, n), want_ds.batch_at(step, shard, n))
    if dtype == np.uint16:  # make_dataset's file kind reads uint16 tokens
        _equal(td.make_dataset(td.DataConfig(**args)).batch_at(2), got_ds.batch_at(2))
    (tmp_path / "short.bin").write_bytes(np.zeros(8, dtype).tobytes())
    with pytest.raises(ValueError, match="too small"):
        td.TokenFileDataset(td.DataConfig(**{**args, "path": str(tmp_path / "short.bin")}),
                            dtype=dtype)


def test_make_dataset_kinds():
    assert isinstance(td.make_dataset(td.DataConfig(4, 2, 10)), td.SyntheticLM)
    with pytest.raises(ValueError):
        td.make_dataset(td.DataConfig(4, 2, 10, kind="parquet"))


@pytest.mark.parametrize("seq_len", [3, 5, 8])
def test_pack_documents_equals_the_jax_packages(seq_len):
    rng = np.random.default_rng(seq_len)
    docs = [rng.integers(1, 50, int(n)) for n in rng.integers(1, 12, 6)]
    got = td.pack_documents(docs, seq_len=seq_len, eos_id=0)
    _equal(got, jd.pack_documents(docs, seq_len=seq_len, eos_id=0))
    for r in range(got["tokens"].shape[0]):
        for j in range(seq_len):
            if got["tokens"][r, j] == 0:
                assert got["labels"][r, j] == -100


def test_prefetcher_serves_the_jax_packages_batches_in_order():
    cfg = dict(seq_len=4, global_batch=2, vocab_size=10)
    ds = td.SyntheticLM(td.DataConfig(**cfg))
    ref = jd.SyntheticLM(jd.DataConfig(**cfg))
    pf = td.Prefetcher(lambda s: ds.batch_at(s), depth=2, start_step=3)
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    for i, b in enumerate(got):
        _equal(b, ref.batch_at(3 + i))
