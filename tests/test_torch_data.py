"""Port parity for the token corpora (``repro_torch.data``): batches
byte-equal to ``repro.data``'s for the same (seed, step, host), and the
reference's resume, host-sharding and structure tests
(``tests/test_data_and_serving.py``), plus ``FileShardedCorpus`` on
``.npy`` shards."""
import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import FileShardedCorpus as JFileShardedCorpus  # noqa: E402
from repro.data import SyntheticCorpus as JSyntheticCorpus  # noqa: E402
from repro_torch.data import (DataConfig, FileShardedCorpus,  # noqa: E402
                              SyntheticCorpus)


@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (9, 7, 0, 1), (9, 123, 0, 1), (1, 3, 1, 4), (1, 3, 3, 4),
    (2 ** 20, 10 ** 6, 2, 8)])
def test_synthetic_batches_equal_the_reference(seed, step, host, hosts):
    kw = dict(vocab_size=777, seq_len=48, global_batch=8, seed=seed,
              branching=5)
    got = SyntheticCorpus(DataConfig(**kw)).batch(step, host, hosts)
    want = JSyntheticCorpus(JDataConfig(**kw)).batch(step, host, hosts)
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    assert got["tokens"].tobytes() == want["tokens"].tobytes()


def test_synthetic_corpus_deterministic_resume():
    """batch(step) is pure: a 'restarted' loader yields identical data."""
    cfg = DataConfig(vocab_size=512, seq_len=64, global_batch=4, seed=9)
    a = SyntheticCorpus(cfg)
    b = SyntheticCorpus(cfg)  # fresh process after restart
    for step in (0, 7, 123):
        np.testing.assert_array_equal(a.batch(step)["tokens"],
                                      b.batch(step)["tokens"])


def test_synthetic_corpus_host_sharding():
    cfg = DataConfig(vocab_size=512, seq_len=32, global_batch=8, seed=1)
    c = SyntheticCorpus(cfg)
    h0 = c.batch(3, host=0, num_hosts=4)["tokens"]
    h1 = c.batch(3, host=1, num_hosts=4)["tokens"]
    assert h0.shape == (2, 32)
    assert not np.array_equal(h0, h1)  # hosts see different data


def test_synthetic_corpus_has_structure():
    """Markov structure: successor tokens come from the bigram table far
    more often than chance."""
    cfg = DataConfig(vocab_size=1024, seq_len=256, global_batch=4, seed=2,
                     order_mix=0.8, branching=4)
    c = SyntheticCorpus(cfg)
    toks = c.batch(0)["tokens"]
    hits = total = 0
    for row in toks:
        for t in range(1, len(row)):
            total += 1
            hits += int(row[t] in c._succ[row[t - 1]])
    assert hits / total > 0.5  # chance would be ~4/1024


def test_synthetic_corpus_iterates_from_step_zero():
    c = SyntheticCorpus(DataConfig(vocab_size=64, seq_len=8, global_batch=2))
    it = iter(c)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      c.batch(step)["tokens"])


@pytest.fixture
def shards(tmp_path):
    rng = np.random.default_rng(4)
    for i, n in enumerate((300, 41, 1000)):
        np.save(tmp_path / f"shard{i:02d}.npy",
                rng.integers(0, 1000, n).astype(np.int32))
    return tmp_path


@pytest.mark.parametrize("step,host,hosts", [(0, 0, 1), (5, 0, 1),
                                             (2, 1, 2), (17, 3, 4)])
def test_file_sharded_corpus_equals_the_reference(shards, step, host, hosts):
    got = FileShardedCorpus(shards, seq_len=32, global_batch=8).batch(
        step, host, hosts)["tokens"]
    want = JFileShardedCorpus(shards, seq_len=32, global_batch=8).batch(
        step, host, hosts)["tokens"]
    assert got.shape == (8 // hosts, 32) and got.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_file_sharded_corpus_reads_rows_of_its_shards(shards):
    c = FileShardedCorpus(shards, seq_len=16, global_batch=3)
    toks = c.batch(1)["tokens"]
    files = [np.load(f) for f in sorted(shards.glob("*.npy"))]
    for b, row in enumerate(toks):
        gidx = 1 * 3 + b
        shard = files[gidx % 3]
        off = (gidx * 9176) % (len(shard) - 16)
        np.testing.assert_array_equal(row, shard[off:off + 16])


def test_file_sharded_corpus_needs_shards(tmp_path):
    with pytest.raises(FileNotFoundError):
        FileShardedCorpus(tmp_path, seq_len=8, global_batch=2)
