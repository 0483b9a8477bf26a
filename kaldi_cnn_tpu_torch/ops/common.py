"""Shared kernel utilities: sizes, device dispatch, and the CUDA library.

Twin of ``kaldi_cnn_tpu/ops/common.py``.  Where the JAX package runs its
Pallas kernels in interpret mode off the TPU, the port dispatches on the
device of the tensor it is given: a CPU tensor takes the kernel's plain
PyTorch version, a CUDA tensor launches the hand-written kernel or
raises.  There is no switch and no fallback from a failed build or
launch to the plain version.

The kernels are CUDA C++ sources in ``kaldi_cnn_tpu_torch/csrc/`` with a
plain C interface.  At first use they are compiled by ``nvcc`` for
``sm_90a``, one process per source in parallel, and linked into
``kaldi_cnn_tpu_torch/_build/libkcnn_cuda.so`` (rebuilt when a source is
newer), which is bound with ``ctypes``.

Each kernel wrapper counts its launches in its ``launches`` attribute
and is registered in ``COUNTED`` (``counted``), so that a CUDA graph
can carry the launches it captured into the counts at every replay
(``core/graphs.py``).  ``device_constant`` keeps a layer geometry's
host-made constants (index tables) on the device, made once: a
host-to-device copy cannot run inside a CUDA graph's capture.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkcnn_cuda.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every kernel entry point; each returns cudaError_t
SIGNATURES = {
    # frames, T, ws, cos, sin, nb, mel, M, window, preemph, remove_dc,
    # out, energy, stream
    "kcnn_fbank": [_P, _I, _I, _P, _P, _I, _P, _I, _P, _F, _I, _P, _P, _P],
    # frames, T, ws, n, twiddle, window, bands, band_w, M, preemph,
    # remove_dc, out, energy, stream
    "kcnn_fbank_fft": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _F, _I, _P, _P,
                       _P],
    "kcnn_fbank_fft_mixed": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _F, _I, _P,
                             _P, _P],
    # x, N, w, b, in_t, in_f, in_c, filt_t, filt_f, F, pool_t, pool_f,
    # relu, out, stream
    "kcnn_conv_maxpool": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P, _P],
    "kcnn_conv_maxpool_wgmma": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _P, _P],
    # x, N, in_t, in_f, in_c, pool_t, pool_f, pool_c, bf16, out, argmax,
    # arg_bytes, stream
    "kcnn_maxpool_fwd": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    "kcnn_maxpool_fwd_vec": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                             _P],
    # out_deriv, argmax, arg_bytes, N, in_t, in_f, in_c, pool_t, pool_f,
    # pool_c, bf16, in_deriv, stream
    "kcnn_maxpool_bwd": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "kcnn_maxpool_bwd_vec": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                             _P],
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


# every kernel wrapper with a launch count, in registration order
COUNTED: List[Callable] = []
_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def counted(fn: Callable) -> Callable:
    """Registers the kernel wrapper ``fn``, whose ``launches`` (set to 0
    here) it increases by one at each launch of its kernel;
    ``warmup_launches`` counts those of them made in a CUDA graph's
    warm-up (``core/graphs.py``)."""
    fn.launches = 0
    fn.warmup_launches = 0
    COUNTED.append(fn)
    return fn


def launch_counts() -> Tuple[int, ...]:
    """Every registered wrapper's count, in ``COUNTED``'s order."""
    return tuple(fn.launches for fn in COUNTED)


def restore_launch_counts(counts: Tuple[int, ...]) -> None:
    """Puts back counts that ``launch_counts`` read."""
    for fn, n in zip(COUNTED, counts):
        fn.launches = n


def device_constant(key: tuple, make: Callable[[], np.ndarray],
                    device) -> torch.Tensor:
    """``torch.as_tensor(make(), device=device)``, made at the first
    call for (``key``, device) and kept: a device tensor that a CUDA
    graph may read, where a fresh host-to-device copy would break the
    capture.  ``key`` must determine ``make()``'s value, and holds a
    layer's geometry only (never a batch's row count), so that the
    table stays as small as the set of layers."""
    device = torch.device(device)
    full = key + (device,)
    t = _CONSTANTS.get(full)
    if t is None:
        t = _CONSTANTS[full] = torch.as_tensor(make(), device=device)
    return t


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "of kaldi_cnn_tpu_torch cannot be built")
    return path


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise with nvcc's output on failure."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into the shared library if it is missing or
    older than a source: one nvcc per source, all started together, then
    one link.  Raises with nvcc's output on failure."""
    srcs = sources()
    stale = (force or not os.path.exists(LIB_PATH)
             or any(os.path.getmtime(LIB_PATH) < os.path.getmtime(s)
                    for s in srcs))
    if not stale:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in srcs]
    compiles = []
    for src, obj in zip(srcs, objs):
        cmd = [_nvcc()] + NVCC_FLAGS + ["-c", src, "-o", obj]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _run(compiles)
    tmp = f"{LIB_PATH}.{tag}"
    cmd = [_nvcc(), "-shared", "-o", tmp] + objs
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, LIB_PATH)      # atomic: concurrent builds race safely
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at first use (the lock is
    taken only until it is loaded)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kcnn_error_string.argtypes = [ctypes.c_int]
            lib.kcnn_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every
    one lies on the CPU; mixed placements raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        msg = library().kcnn_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of the device's current stream: the lookup
    that ``torch.cuda.current_stream(device).cuda_stream`` makes, without
    building a Stream object (0.1 instead of 5.6 us a call, measured on
    the host of an H100 machine)."""
    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple) -> None:
    """Validate a kernel operand before its pointer crosses to C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous tensor")
