"""Compressed feature matrices.

Clean-room equivalent of src/matrix/compressed-matrix.{h,cc}
(CompressedMatrix): per-column quantization of float32 feature
matrices to uint8 with a 4-point percentile header per column
(p0, p25, p75, p100), Kaldi's on-disk feature compression
(--compress=true in copy-feats/make_mfcc).  The codec here keeps the
same structure (column headers + uint8 codes, ~4x smaller than f32)
with numpy-vectorized round trip.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def compress_matrix(mat: np.ndarray) -> Dict[str, np.ndarray]:
    """float32 [T, D] -> {header [D, 4] f32, codes [T, D] u8}."""
    m = np.asarray(mat, np.float32)
    if m.size == 0:
        return {"header": np.zeros((m.shape[1] if m.ndim > 1 else 0, 4),
                                   np.float32),
                "codes": np.zeros(m.shape, np.uint8),
                "shape": np.asarray(m.shape, np.int64)}
    p = np.percentile(m, [0, 25, 75, 100], axis=0).T.astype(np.float32)
    # avoid zero ranges
    eps = 1e-5 + 1e-6 * np.abs(p)
    p[:, 1] = np.maximum(p[:, 1], p[:, 0] + eps[:, 0])
    p[:, 2] = np.maximum(p[:, 2], p[:, 1] + eps[:, 1])
    p[:, 3] = np.maximum(p[:, 3], p[:, 2] + eps[:, 2])
    codes = np.empty(m.shape, np.uint8)
    # 3 linear segments: [p0,p25] -> 0..64, [p25,p75] -> 64..192,
    # [p75,p100] -> 192..255 (the reference's piecewise mapping)
    lo, q1, q3, hi = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    x = m
    seg1 = np.clip((x - lo) / (q1 - lo), 0, 1) * 64.0
    seg2 = 64.0 + np.clip((x - q1) / (q3 - q1), 0, 1) * 128.0
    seg3 = 192.0 + np.clip((x - q3) / (hi - q3), 0, 1) * 63.0
    codes = np.where(x <= q1, seg1, np.where(x <= q3, seg2, seg3))
    codes = np.round(codes).astype(np.uint8)
    return {"header": p, "codes": codes,
            "shape": np.asarray(m.shape, np.int64)}


def decompress_matrix(blob: Dict[str, np.ndarray]) -> np.ndarray:
    p = blob["header"]
    codes = blob["codes"].astype(np.float32)
    lo, q1, q3, hi = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    in1 = codes <= 64.0
    in2 = (codes > 64.0) & (codes <= 192.0)
    out = np.where(
        in1, lo + (q1 - lo) * (codes / 64.0),
        np.where(in2, q1 + (q3 - q1) * ((codes - 64.0) / 128.0),
                 q3 + (hi - q3) * ((codes - 192.0) / 63.0)))
    return out.astype(np.float32)


def save_compressed_ark(path: str, mats: Dict[str, np.ndarray]) -> None:
    """npz shard of compressed matrices (the native sharded feature
    store; ark interop stays float via io.kaldi_io)."""
    blobs = {}
    for utt, m in mats.items():
        b = compress_matrix(m)
        blobs[f"{utt}.header"] = b["header"]
        blobs[f"{utt}.codes"] = b["codes"]
    np.savez_compressed(path, **blobs)


def load_compressed_ark(path: str) -> Dict[str, np.ndarray]:
    z = np.load(path)
    utts = sorted({k.rsplit(".", 1)[0] for k in z.files})
    return {u: decompress_matrix({"header": z[f"{u}.header"],
                                  "codes": z[f"{u}.codes"]})
            for u in utts}
