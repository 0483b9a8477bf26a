"""On-disk sharded egs with deterministic streaming — the scalable
replacement for the all-in-RAM ``Egs``.

The reference shards egs on disk and streams them precisely because
full-corpus spliced frames do not fit memory (ref:
steps/nnet2/get_egs.sh writing egs.JOB.ark; nnet2bin/nnet-copy-egs.cc
round-robin distribution; nnet-shuffle-egs.cc buffered shuffling).
Equivalent here:

  write_sharded_egs   streams (x, y, w) blocks to N shards.  Each row
                      is multinomially assigned to a shard by a seeded
                      RNG and within-shard order is shuffled at
                      finalize — together that IS a uniform global
                      shuffle (the standard external-shuffle
                      construction), done with peak memory of one
                      shard, not the corpus.
  ShardedEgs          the on-disk store (meta + egs.<i>.npz shards).
  StreamingEgsBatcher drop-in for train.egs.EgsBatcher: per-epoch
                      seeded shard order + within-shard permutation,
                      minibatches carried across shard boundaries,
                      next shard prefetched on a worker thread.  The
                      batch sequence is a pure function of
                      (seed, epoch) — prefetch timing and storage
                      backend cannot change it, so streaming training
                      is bit-for-bit the in-memory result.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_cnn_tpu_torch.core.rng import np_rng
from kaldi_cnn_tpu_torch.train.egs import Egs


class ShardedEgsWriter:
    """Streaming writer: feed (x, y, w) blocks of any size; rows are
    scattered across shards pending on disk, then each shard is
    shuffled and finalized.  Peak RSS = one block + one shard."""

    def __init__(self, out_dir: str, num_shards: int = 8, seed: int = 0):
        assert num_shards >= 1
        self.dir = out_dir
        self.num_shards = num_shards
        self.seed = seed
        os.makedirs(out_dir, exist_ok=True)
        self._tmp_x = [open(self._tmp_path(i, "x"), "wb")
                       for i in range(num_shards)]
        self._tmp_y = [open(self._tmp_path(i, "y"), "wb")
                       for i in range(num_shards)]
        self._tmp_w = [open(self._tmp_path(i, "w"), "wb")
                       for i in range(num_shards)]
        self._rng = np_rng(seed, "egs_shard_assign")
        self._dim: Optional[int] = None
        self._counts = [0] * num_shards

    def _tmp_path(self, i: int, part: str) -> str:
        return os.path.join(self.dir, f".tmp.{i}.{part}")

    def add(self, x: np.ndarray, y: np.ndarray,
            w: Optional[np.ndarray] = None) -> None:
        x = np.ascontiguousarray(x, np.float32)
        y = np.ascontiguousarray(y, np.int32)
        w = (np.ones(len(y), np.float32) if w is None
             else np.ascontiguousarray(w, np.float32))
        if self._dim is None:
            self._dim = x.shape[1]
        assert x.shape[1] == self._dim
        shard = self._rng.integers(0, self.num_shards, len(y))
        for i in range(self.num_shards):
            sel = shard == i
            if not sel.any():
                continue
            self._tmp_x[i].write(x[sel].tobytes())
            self._tmp_y[i].write(y[sel].tobytes())
            self._tmp_w[i].write(w[sel].tobytes())
            self._counts[i] += int(sel.sum())

    def finalize(self) -> "ShardedEgs":
        """Shuffle each shard in isolation and write egs.<i>.npz
        (ref: nnet-shuffle-egs applied per archive)."""
        for fs in (self._tmp_x, self._tmp_y, self._tmp_w):
            for f in fs:
                f.close()
        dim = self._dim or 0
        for i in range(self.num_shards):
            n = self._counts[i]
            x = np.fromfile(self._tmp_path(i, "x"),
                            np.float32).reshape(n, dim)
            y = np.fromfile(self._tmp_path(i, "y"), np.int32)
            w = np.fromfile(self._tmp_path(i, "w"), np.float32)
            perm = np_rng(self.seed, "egs_shard_shuffle",
                          i).permutation(n)
            np.savez(os.path.join(self.dir, f"egs.{i}.npz"),
                     x=x[perm], y=y[perm], weights=w[perm])
            for part in ("x", "y", "w"):
                os.remove(self._tmp_path(i, part))
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump({"num_shards": self.num_shards, "dim": dim,
                       "counts": self._counts, "seed": self.seed}, f)
        return ShardedEgs(self.dir)


def write_sharded_egs(out_dir: str,
                      blocks: Iterator[Tuple[np.ndarray, np.ndarray,
                                             Optional[np.ndarray]]],
                      num_shards: int = 8, seed: int = 0) -> "ShardedEgs":
    w = ShardedEgsWriter(out_dir, num_shards, seed)
    for blk in blocks:
        w.add(*blk)
    return w.finalize()


class ShardedEgs:
    """On-disk sharded egs store with per-shard lazy loading."""

    def __init__(self, path: str):
        self.dir = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.num_shards = self.meta["num_shards"]
        self.counts = self.meta["counts"]
        self.dim = self.meta["dim"]

    def __len__(self) -> int:
        return sum(self.counts)

    def load_shard(self, i: int) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        z = np.load(os.path.join(self.dir, f"egs.{i}.npz"))
        return z["x"], z["y"], z["weights"]

    def load_all(self) -> Egs:
        """Materialize everything (small stores / validation sets)."""
        xs, ys, ws = zip(*(self.load_shard(i)
                           for i in range(self.num_shards)))
        return Egs(np.concatenate(xs), np.concatenate(ys),
                   np.concatenate(ws))


class InMemoryShards:
    """Same store contract as ShardedEgs, shards held in RAM — the
    in-memory reference the streaming path must match bit-for-bit."""

    def __init__(self, shards: Sequence[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]]):
        self.shards = list(shards)
        self.num_shards = len(self.shards)
        self.counts = [len(s[1]) for s in self.shards]
        self.dim = self.shards[0][0].shape[1] if self.shards else 0

    def __len__(self) -> int:
        return sum(self.counts)

    def load_shard(self, i: int):
        return self.shards[i]


class _Prefetcher:
    """One-shard-ahead background loader."""

    def __init__(self, store: ShardedEgs, order: Sequence[int]):
        self.store = store
        self.order = list(order)
        self._results: dict = {}
        self._pos = 0
        self._thread: Optional[threading.Thread] = None
        self._start(0)

    def _start(self, pos: int) -> None:
        if pos >= len(self.order):
            return

        def work(p=pos):
            self._results[p] = self.store.load_shard(self.order[p])

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def get(self, pos: int):
        if self._thread is not None:
            self._thread.join()
        if pos not in self._results:         # resume skipped ahead
            self._results[pos] = self.store.load_shard(self.order[pos])
        out = self._results.pop(pos)
        self._start(pos + 1)
        return out


class StreamingEgsBatcher:
    """EgsBatcher contract (num_batches / epoch) over a ShardedEgs.

    The batch sequence for (seed, epoch) is fully determined before any
    IO happens: shard order is a seeded permutation, each shard's rows
    get a seeded permutation, and minibatches are cut from the
    concatenated permuted stream — so a resumed or re-run epoch
    reproduces identical batches, and the in-memory result is
    bit-for-bit the streamed result (tested).  ``epoch(e, start_batch)``
    resumes mid-epoch by skipping whole shards where possible."""

    def __init__(self, store: ShardedEgs, minibatch_size: int = 512,
                 seed: int = 0):
        self.store = store
        self.minibatch_size = minibatch_size
        self.seed = seed

    def num_batches(self) -> int:
        return -(-len(self.store) // self.minibatch_size)

    def _epoch_plan(self, epoch_idx: int):
        order = np_rng(self.seed, "egs_epoch_shards",
                       epoch_idx).permutation(self.store.num_shards)
        perms = [np_rng(self.seed, f"egs_epoch_rows_{int(s)}",
                        epoch_idx).permutation(self.store.counts[int(s)])
                 for s in order]
        return order, perms

    def epoch(self, epoch_idx: int, start_batch: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        mb = self.minibatch_size
        order, perms = self._epoch_plan(epoch_idx)
        pre = _Prefetcher(self.store, order)
        # pad RNG mirrors EgsBatcher's trailing-batch padding
        pad_rng = np_rng(self.seed, "egs_epoch_pad", epoch_idx)
        carry: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        carry_n = 0
        batch_idx = 0
        for pos in range(len(order)):
            x, y, w = pre.get(pos)
            p = perms[pos]
            carry.append((x[p], y[p], w[p]))
            del x, y, w          # drop the unpermuted shard immediately
            carry_n += len(p)
            while carry_n >= mb:
                bx, by, bw, carry, carry_n = _cut(carry, carry_n, mb)
                if batch_idx >= start_batch:
                    yield bx, by, bw
                batch_idx += 1
        if carry_n:
            bx, by, bw, _, _ = _cut(carry, carry_n, carry_n)
            pad = pad_rng.integers(0, max(carry_n, 1), mb - carry_n)
            bx = np.concatenate([bx, bx[pad]])
            by = np.concatenate([by, by[pad]])
            bw = np.concatenate(
                [bw, np.zeros(mb - carry_n, np.float32)])
            if batch_idx >= start_batch:
                yield bx, by, bw
            batch_idx += 1


def _cut(parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
         total: int, n: int):
    """Take the first n rows off the part list; returns the batch
    arrays plus the remaining parts/count."""
    took_x, took_y, took_w = [], [], []
    need = n
    rest: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for x, y, w in parts:
        if need <= 0:
            rest.append((x, y, w))
            continue
        k = min(need, len(y))
        took_x.append(x[:k])
        took_y.append(y[:k])
        took_w.append(w[:k])
        if k < len(y):
            rest.append((x[k:], y[k:], w[k:]))
        need -= k
    return (np.concatenate(took_x), np.concatenate(took_y),
            np.concatenate(took_w), rest, total - n)
