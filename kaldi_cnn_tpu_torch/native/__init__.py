"""Native (C++) host components with ctypes bindings (copy of
``kaldi_cnn_tpu/native/__init__.py``).

Every ``.cc`` source in this package is compiled on first use into one
cached shared library (g++ -O3) under ``kaldi_cnn_tpu_torch/_build/``
(written to a temporary name and renamed, so concurrent builds never
load a half-written file) and bound via ctypes, with numpy / pure-Python
fallbacks in the callers when no toolchain is available.

Current components, both verbatim copies of the JAX package's:
  viterbi.cc  — host token-passing core (ref: faster-decoder.cc), used
                by decode.decoder for alignment.
  tableio.cc  — ark archive scanner (ref: util/kaldi-table-inl.h
                readers), used by io.native_io for mmap-backed
                sequential/random-access Table readers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkctnative.so")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def load() -> Optional[ctypes.CDLL]:
    """Compile-on-demand + cache.  Returns None when the toolchain is
    missing (callers fall back to numpy)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    srcs = [os.path.join(_HERE, f) for f in sorted(os.listdir(_HERE))
            if f.endswith(".cc")]
    try:
        if (not os.path.exists(LIB_PATH)
                or any(os.path.getmtime(LIB_PATH) < os.path.getmtime(s)
                       for s in srcs)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                   "-o", tmp] + srcs
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, LIB_PATH)   # atomic: concurrent builds race
        lib = ctypes.CDLL(LIB_PATH)
    except (OSError, subprocess.SubprocessError, FileNotFoundError):
        return None
    import numpy as np
    from numpy.ctypeslib import ndpointer
    i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32 = ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.kct_viterbi.restype = ctypes.c_int64
    lib.kct_viterbi.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, i32, i32, i32, i32, f32, i32,
        ctypes.c_int64, i32, i32, i32, f32,
        f32,
        f32, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float,
        i32, i32, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
    ]
    u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.kct_ark_index.restype = ctypes.c_int64
    lib.kct_ark_index.argtypes = [
        u8, ctypes.c_int64, ctypes.c_int64,
        i64, i32, i64, i32, i32, i32,
    ]
    lib.kct_ark_read_ivec.restype = ctypes.c_int32
    lib.kct_ark_read_ivec.argtypes = [u8, ctypes.c_int32, i32]
    _LIB = lib
    return _LIB
