"""mmap-backed ark Table readers over the native C++ scanner.

TPU-native rework of the reference's Table I/O read path
(ref: src/util/kaldi-table.h SequentialTableReader /
RandomAccessTableReader, kaldi-table-inl.h): instead of a C++ stream
parser per process, one native scan (native/tableio.cc kct_ark_index)
indexes the whole archive and entries are served as zero-copy numpy
views of a single mmap — the shape that feeds TPU host loading well
(bulk, page-cache friendly, no per-entry Python parsing).

Falls back to the pure-Python reader in io/kaldi_io.py when the native
toolchain is unavailable (same transparent-fallback contract as the
reference's CuDevice CPU fallback).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from kaldi_cnn_tpu_torch import native
from kaldi_cnn_tpu_torch.io import kaldi_io

_DTYPES = {0: (np.float32, 2), 1: (np.float64, 2),
           2: (np.float32, 1), 3: (np.float64, 1)}


class ArkIndex:
    """Parsed archive index: keys -> (payload offset, rows, cols, dtype)."""

    def __init__(self, path: str):
        self.path = path
        self.buf = np.memmap(path, dtype=np.uint8, mode="r")
        lib = native.load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        cap = 1024
        while True:
            key_off = np.empty(cap, np.int64)
            key_len = np.empty(cap, np.int32)
            pay_off = np.empty(cap, np.int64)
            rows = np.empty(cap, np.int32)
            cols = np.empty(cap, np.int32)
            dtype = np.empty(cap, np.int32)
            n = lib.kct_ark_index(self.buf, len(self.buf), cap, key_off,
                                  key_len, pay_off, rows, cols, dtype)
            if n < 0:
                raise ValueError(f"malformed ark archive: {path}")
            if n < cap:
                break
            cap *= 8
        self.keys: List[str] = [
            bytes(self.buf[key_off[i]:key_off[i] + key_len[i]]).decode()
            for i in range(n)]
        self.pay_off = pay_off[:n]
        self.rows = rows[:n]
        self.cols = cols[:n]
        self.dtype = dtype[:n]
        self._by_key = {k: i for i, k in enumerate(self.keys)}

    def __len__(self) -> int:
        return len(self.keys)

    def value(self, i: int) -> np.ndarray:
        off = int(self.pay_off[i])
        r, c, dt = int(self.rows[i]), int(self.cols[i]), int(self.dtype[i])
        if dt == 4:
            out = np.empty(r, np.int32)
            lib = native.load()
            if lib.kct_ark_read_ivec(
                    np.ascontiguousarray(self.buf[off:off + 5 * r]), r,
                    out) != 0:
                raise ValueError("malformed int vector")
            return out
        np_dt, ndim = _DTYPES[dt]
        nbytes = r * c * np.dtype(np_dt).itemsize
        flat = self.buf[off:off + nbytes].view(np_dt)
        return flat.reshape(r, c) if ndim == 2 else flat


class SequentialArkReader:
    """Iterate (key, value) over an ark; values are zero-copy mmap
    views for float payloads (ref: SequentialTableReader)."""

    def __init__(self, path: str):
        self._index: Optional[ArkIndex]
        try:
            self._index = ArkIndex(path)
        except (RuntimeError, ValueError):
            self._index = None
        self._path = path

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        if self._index is None:
            yield from kaldi_io.read_ark(self._path)
            return
        for i, k in enumerate(self._index.keys):
            yield k, self._index.value(i)


class RandomAccessArkReader:
    """Key-addressed reads without loading the archive
    (ref: RandomAccessTableReader)."""

    def __init__(self, path: str):
        try:
            self._index = ArkIndex(path)
            self._dict: Optional[Dict[str, np.ndarray]] = None
        except (RuntimeError, ValueError):
            self._index = None
            self._dict = dict(kaldi_io.read_ark(path))

    def __contains__(self, key: str) -> bool:
        if self._index is not None:
            return key in self._index._by_key
        return key in self._dict

    def __getitem__(self, key: str) -> np.ndarray:
        if self._index is not None:
            return self._index.value(self._index._by_key[key])
        return self._dict[key]

    def keys(self):
        if self._index is not None:
            return list(self._index.keys)
        return list(self._dict)
