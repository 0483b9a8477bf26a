"""Kaldi-compatible ark/scp Table I/O.

Bit-compatible reimplementation (from the published format, not the
code) of the reference's archive streams:
  - src/util/kaldi-table.h   (SequentialTableReader/TableWriter)
  - src/util/kaldi-holder.h  (per-type Holders)
  - src/base/io-funcs.{h,cc} (binary header "\\0B", tokens, basic types)

Formats:
  * binary archive entry:  b"<key> \\x00B" + holder payload
      - FloatMatrix:  b"FM " + int32(rows) + int32(cols) + row-major f32
        (each int32 written as \\x04 size-byte + 4 LE bytes)
      - FloatVector:  b"FV " + int32(dim) + f32 data
      - DM / DV: float64 variants
      - int32 vector (alignments): b"\\x04" + int32(n) + n * (b"\\x04"+int32)
  * text archive entry:  "<key>  [\\n  r0c0 r0c1 ...\\n  ... ]\\n"
  * scp line: "<key> <path>:<byte offset>"

Only the subset the recipes need is implemented; pipes ("cmd |" /
"| cmd") and offsets ("file:123") in rxfilenames are supported.
"""

from __future__ import annotations

import io
import os
import struct
import subprocess
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np

Value = Union[np.ndarray, list]


# --------------------------------------------------------------------------
# low-level binary primitives (ref: src/base/io-funcs.cc)
# --------------------------------------------------------------------------

def _write_int32(f, v: int) -> None:
    f.write(b"\x04" + struct.pack("<i", v))


def _read_int32(f) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"expected int32 size byte, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            raise EOFError("eof in token")
        if c == b" ":
            break
        tok += c
    return tok.decode()


# --------------------------------------------------------------------------
# holders
# --------------------------------------------------------------------------

_MAT_TOKENS = {"FM": np.float32, "DM": np.float64}
_VEC_TOKENS = {"FV": np.float32, "DV": np.float64}


def _write_value_binary(f, value) -> None:
    f.write(b"\x00B")
    if isinstance(value, np.ndarray) and value.ndim == 2:
        token = "FM" if value.dtype != np.float64 else "DM"
        f.write(token.encode() + b" ")
        _write_int32(f, value.shape[0])
        _write_int32(f, value.shape[1])
        f.write(np.ascontiguousarray(
            value, dtype=_MAT_TOKENS[token]).tobytes())
    elif isinstance(value, np.ndarray) and value.ndim == 1 and \
            value.dtype.kind == "f":
        token = "FV" if value.dtype != np.float64 else "DV"
        f.write(token.encode() + b" ")
        _write_int32(f, value.shape[0])
        f.write(np.ascontiguousarray(
            value, dtype=_VEC_TOKENS[token]).tobytes())
    elif isinstance(value, (list, tuple)) or (
            isinstance(value, np.ndarray) and value.dtype.kind == "i"):
        ints = np.asarray(value, dtype=np.int32)
        _write_int32(f, len(ints))
        for v in ints:
            _write_int32(f, int(v))
    else:
        raise TypeError(f"unsupported value type {type(value)}")


def _read_value_binary(f):
    head = f.read(2)
    if head != b"\x00B":
        raise ValueError(f"expected binary header, got {head!r}")
    pos = f.tell()
    first = f.read(1)
    if first == b"\x04":
        # int32 vector (no type token)
        f.seek(pos)
        n = _read_int32(f)
        out = np.empty(n, dtype=np.int32)
        for i in range(n):
            out[i] = _read_int32(f)
        return out
    f.seek(pos)
    token = _read_token(f)
    if token in _MAT_TOKENS:
        rows = _read_int32(f)
        cols = _read_int32(f)
        dtype = _MAT_TOKENS[token]
        data = f.read(rows * cols * np.dtype(dtype).itemsize)
        return np.frombuffer(data, dtype=dtype).reshape(rows, cols).copy()
    if token in _VEC_TOKENS:
        dim = _read_int32(f)
        dtype = _VEC_TOKENS[token]
        data = f.read(dim * np.dtype(dtype).itemsize)
        return np.frombuffer(data, dtype=dtype).copy()
    raise ValueError(f"unknown holder token {token!r}")


def _write_value_text(f, value) -> None:
    if isinstance(value, np.ndarray) and value.ndim == 2:
        f.write(b" [\n")
        for row in value:
            f.write(("  " + " ".join(f"{x:.7g}" for x in row)).encode())
            f.write(b"\n")
        f.write(b" ]\n")
    elif isinstance(value, np.ndarray) and value.ndim == 1 and \
            value.dtype.kind == "f":
        f.write((" [ " + " ".join(f"{x:.7g}" for x in value) + " ]\n").encode())
    else:
        ints = np.asarray(value, dtype=np.int32)
        f.write((" " + " ".join(str(int(v)) for v in ints) + "\n").encode())


# --------------------------------------------------------------------------
# extended filenames (ref: src/util/kaldi-io.cc ClassifyRxfilename)
# --------------------------------------------------------------------------

def open_rx(rxfilename: str):
    """Open an extended input filename: '-', 'cmd |', 'file', 'file:offset'."""
    if rxfilename == "-":
        return io.BytesIO(os.sys.stdin.buffer.read())
    if rxfilename.endswith("|"):
        proc = subprocess.run(rxfilename[:-1], shell=True,
                              stdout=subprocess.PIPE, check=True)
        return io.BytesIO(proc.stdout)
    if ":" in rxfilename:
        path, _, off = rxfilename.rpartition(":")
        if off.isdigit() and os.path.exists(path):
            f = open(path, "rb")
            f.seek(int(off))
            return f
    return open(rxfilename, "rb")


# --------------------------------------------------------------------------
# archive read/write
# --------------------------------------------------------------------------

def write_ark(
    ark_path: str,
    data: Dict[str, Value],
    scp_path: Optional[str] = None,
    binary: bool = True,
) -> None:
    with ArkWriter(ark_path, scp_path, binary) as w:
        for key, value in data.items():
            w.write(key, value)


class ArkWriter:
    """TableWriter equivalent: streams (key, value) to ark (+ scp)."""

    def __init__(self, ark_path: str, scp_path: Optional[str] = None,
                 binary: bool = True):
        self._ark = open(ark_path, "wb")
        self._ark_path = os.path.abspath(ark_path)
        self._scp = open(scp_path, "w") if scp_path else None
        self._binary = binary

    def write(self, key: str, value: Value) -> None:
        self._ark.write(key.encode() + b" ")
        offset = self._ark.tell()
        if self._binary:
            _write_value_binary(self._ark, value)
        else:
            _write_value_text(self._ark, value)
        if self._scp:
            self._scp.write(f"{key} {self._ark_path}:{offset}\n")

    def close(self) -> None:
        self._ark.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_key(f) -> Optional[str]:
    key = b""
    while True:
        c = f.read(1)
        if not c:
            return None if not key else key.decode()
        if c == b" ":
            return key.decode()
        if c in b"\n\t" and not key:
            continue
        key += c


def read_ark(rxfilename: str) -> Iterator[Tuple[str, np.ndarray]]:
    """SequentialTableReader equivalent over a (binary) archive."""
    f = open_rx(rxfilename)
    try:
        while True:
            key = _read_key(f)
            if key is None:
                return
            yield key, _read_value_binary(f)
    finally:
        f.close()


def read_mat_ark(rxfilename: str) -> Iterator[Tuple[str, np.ndarray]]:
    return read_ark(rxfilename)


def read_vec_int_ark(rxfilename: str) -> Iterator[Tuple[str, np.ndarray]]:
    return read_ark(rxfilename)


def read_scp(scp_path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """RandomAccessTableReader-style: resolve 'key path:offset' lines."""
    with open(scp_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, rx = line.split(None, 1)
            g = open_rx(rx)
            try:
                yield key, _read_value_binary(g)
            finally:
                g.close()


def read_scp_dict(scp_path: str) -> Dict[str, np.ndarray]:
    return dict(read_scp(scp_path))
