"""The port's on-disk sharded egs (``train/sharded_egs.py``, a twin of
the JAX package's) and ``wsj.write_cnn_egs_sharded``: the tier-1 cases
of ``tests/test_sharded_egs.py`` run on the port (coverage, one pass an
epoch, determinism and resume, bounded memory, streamed training equal
to in-memory training bit for bit, the writer's round trip), the twins
by source text, and stores that either package writes read back bit for
bit through the other."""

import inspect
import os
import tracemalloc

import numpy as np
import pytest
import torch

from kaldi_cnn_tpu.recipes import wsj as jwsj
from kaldi_cnn_tpu.train import sharded_egs as jse
from kaldi_cnn_tpu_torch.models.components import (AffineComponent,
                                                   NormalizeComponent,
                                                   PnormComponent,
                                                   SoftmaxComponent)
from kaldi_cnn_tpu_torch.models.nnet import Nnet
from kaldi_cnn_tpu_torch.recipes import wsj
from kaldi_cnn_tpu_torch.train.egs import Egs
from kaldi_cnn_tpu_torch.train.sharded_egs import (
    InMemoryShards, ShardedEgs, ShardedEgsWriter, StreamingEgsBatcher,
    write_sharded_egs)
from kaldi_cnn_tpu_torch.train.trainer import TrainConfig, train_nnet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_store(tmp_path, n_rows=3000, dim=20, num_shards=8, seed=0,
                block=257, writer=ShardedEgsWriter):
    rng = np.random.default_rng(seed)
    w = writer(str(tmp_path / "egs"), num_shards, seed)
    all_x, all_y = [], []
    for i in range(0, n_rows, block):
        n = min(block, n_rows - i)
        x = rng.normal(size=(n, dim)).astype(np.float32)
        # row id hidden in column 0 for exact-coverage accounting
        x[:, 0] = np.arange(i, i + n)
        y = rng.integers(0, 10, n).astype(np.int32)
        all_x.append(x)
        all_y.append(y)
        w.add(x, y)
    return w.finalize(), np.concatenate(all_x), np.concatenate(all_y)


def test_twins_are_verbatim():
    """The port's file is the JAX package's with its imports pointed at
    the port, and so is write_cnn_egs_sharded."""
    def src(path):
        with open(os.path.join(ROOT, path)) as f:
            return f.read()

    def mapped(text):
        return text.replace("from kaldi_cnn_tpu.", "from kaldi_cnn_tpu_torch.")

    assert src("kaldi_cnn_tpu_torch/train/sharded_egs.py") == mapped(
        src("kaldi_cnn_tpu/train/sharded_egs.py"))
    assert inspect.getsource(wsj.write_cnn_egs_sharded) == mapped(
        inspect.getsource(jwsj.write_cnn_egs_sharded))


def test_shards_cover_all_rows_with_global_shuffle(tmp_path):
    store, x, y = _make_store(tmp_path)
    assert store.num_shards == 8
    assert len(store) == len(y)
    assert min(store.counts) > 0
    got = np.sort(np.concatenate(
        [store.load_shard(i)[0][:, 0] for i in range(8)]))
    np.testing.assert_array_equal(got, np.arange(len(y)))
    s0 = store.load_shard(0)[0][:, 0]
    assert not np.array_equal(s0, np.sort(s0))


def test_epoch_covers_every_example_once(tmp_path):
    store, x, y = _make_store(tmp_path)
    b = StreamingEgsBatcher(store, minibatch_size=256, seed=3)
    seen = []
    n_batches = 0
    for bx, by, bw in b.epoch(0):
        assert bx.shape == (256, 20) and by.shape == (256,)
        seen.append(bx[bw > 0, 0])
        n_batches += 1
    assert n_batches == b.num_batches()
    got = np.sort(np.concatenate(seen))
    np.testing.assert_array_equal(got, np.arange(len(y)))


def test_epoch_deterministic_and_resumable(tmp_path):
    store, _, _ = _make_store(tmp_path)
    b = StreamingEgsBatcher(store, minibatch_size=256, seed=3)
    full = list(b.epoch(1))
    again = list(b.epoch(1))
    for a, c in zip(full, again, strict=True):
        for u, v in zip(a, c):
            np.testing.assert_array_equal(u, v)
    tail = list(b.epoch(1, start_batch=5))
    assert len(tail) == len(full) - 5
    for a, c in zip(full[5:], tail, strict=True):
        for u, v in zip(a, c):
            np.testing.assert_array_equal(u, v)
    other = list(b.epoch(2))
    assert not np.array_equal(full[0][0], other[0][0])


def test_streaming_peak_memory_bounded_below_total(tmp_path):
    n_rows, dim = 16384, 256           # 16 MB of egs total
    store, _, _ = _make_store(tmp_path, n_rows=n_rows, dim=dim,
                              num_shards=16)
    total_bytes = n_rows * dim * 4
    b = StreamingEgsBatcher(store, minibatch_size=256, seed=0)
    tracemalloc.start()
    for bx, by, bw in b.epoch(0):
        pass
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < total_bytes * 0.5, (peak, total_bytes)


def test_streamed_training_matches_inmemory_bitforbit(tmp_path):
    """The port's train_nnet on shards streamed from disk equals it on the
    same shards held in memory, bit for bit."""
    store, x, y = _make_store(tmp_path, n_rows=2000, dim=20)
    mem = InMemoryShards([store.load_shard(i)
                          for i in range(store.num_shards)])
    egs_valid = Egs(x[:256], y[:256], np.ones(256, np.float32))
    cfg = TrainConfig(num_epochs=2, minibatch_size=256,
                      initial_learning_rate=0.02,
                      final_learning_rate=0.01, seed=5,
                      combine_num_models=1)

    def trained(store_):
        net = Nnet([AffineComponent(20, 32, device="cpu"),
                    PnormComponent(32, 16), NormalizeComponent(16),
                    AffineComponent(16, 10, device="cpu"),
                    SoftmaxComponent(10)])
        params, _ = train_nnet(net, None, egs_valid, cfg,
                               batcher=StreamingEgsBatcher(store_, 256,
                                                           seed=5))
        return params

    for a, b in zip(trained(store), trained(mem), strict=True):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def test_write_sharded_egs_roundtrip(tmp_path):
    def blocks():
        rng = np.random.default_rng(0)
        for _ in range(4):
            yield (rng.normal(size=(100, 8)).astype(np.float32),
                   rng.integers(0, 5, 100).astype(np.int32), None)

    store = write_sharded_egs(str(tmp_path / "e"), blocks(),
                              num_shards=3, seed=1)
    assert len(store) == 400
    reloaded = ShardedEgs(str(tmp_path / "e"))
    assert len(reloaded) == 400
    egs = reloaded.load_all()
    assert egs.x.shape == (400, 8)
    np.testing.assert_array_equal(egs.weights, np.ones(400, np.float32))


def _volumes(seed=4, n=5):
    r = np.random.default_rng(seed)
    vols, ali = {}, {}
    for i in range(n):
        t = int(r.integers(20, 60))
        vols[f"u{i}"] = r.normal(size=(t, 12, 3)).astype(np.float32)
        ali[f"u{i}"] = r.integers(1, 40, t).astype(np.int32)
    ali["u3"] = ali["u3"][:-1]         # a length mismatch is skipped
    return vols, ali, np.arange(40, dtype=np.int32) % 17


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cnn_stores_read_back_across_packages(tmp_path, writer):
    """write_cnn_egs_sharded of either package: the other package's
    ShardedEgs and StreamingEgsBatcher read the same bits as the writer's
    own, shard by shard and batch by batch."""
    vols, ali, t2p = _volumes()
    write = {"jax": jwsj.write_cnn_egs_sharded,
             "port": wsj.write_cnn_egs_sharded}[writer]
    write(str(tmp_path / "egs"), vols, ali, t2p, 2, 2, num_shards=3, seed=6)
    port, jax_ = ShardedEgs(str(tmp_path / "egs")), jse.ShardedEgs(
        str(tmp_path / "egs"))
    assert port.meta == jax_.meta and len(port) == len(jax_) > 0
    for i in range(3):
        for a, b in zip(port.load_shard(i), jax_.load_shard(i), strict=True):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(StreamingEgsBatcher(port, 32, 2).epoch(1),
                    jse.StreamingEgsBatcher(jax_, 32, 2).epoch(1),
                    strict=True):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def test_cnn_stores_equal_across_packages(tmp_path):
    """The two packages' write_cnn_egs_sharded write the same files."""
    vols, ali, t2p = _volumes(seed=8)
    wsj.write_cnn_egs_sharded(str(tmp_path / "p"), vols, ali, t2p, 5, 5,
                              num_shards=4, seed=2)
    jwsj.write_cnn_egs_sharded(str(tmp_path / "j"), vols, ali, t2p, 5, 5,
                               num_shards=4, seed=2)
    p, j = ShardedEgs(str(tmp_path / "p")), ShardedEgs(str(tmp_path / "j"))
    assert p.meta == j.meta and p.dim == 11 * 12 * 3
    egs_p, egs_j = p.load_all(), j.load_all()
    for a, b in zip((egs_p.x, egs_p.y, egs_p.weights),
                    (egs_j.x, egs_j.y, egs_j.weights)):
        np.testing.assert_array_equal(a, b)
