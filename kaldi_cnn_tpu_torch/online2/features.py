"""Streaming (online) feature pipeline (twin of
``kaldi_cnn_tpu/online2/features.py``).

Clean-room equivalent of src/online2/online-nnet2-feature-pipeline.{h,cc}
(OnlineNnet2FeaturePipeline) over src/feat/online-feature.{h,cc}
(OnlineMfcc/OnlineFbank, OnlineCmvn, OnlineDeltaFeature,
OnlineSpliceFrames): audio arrives in chunks; base features are
computed incrementally for the frames whose full window is buffered
(snip-edges semantics, so frame t depends only on samples
[t*shift, t*shift + window)); CMVN uses the frames seen so far
(frozen-state semantics available via freeze()); deltas/splicing lag by
their right context.

``OnlineBaseFeature`` computes each newly ready piece through
``ops.fbank.fbank`` / ``ops.fbank.mfcc`` on its ``device``: the fbank
kernel on a CUDA device, its plain version on the CPU.  Dither noise
comes from an explicit ``torch.Generator`` (stage ``("online_dither",
0)`` unless one is given), drawn piece by piece.  ``OnlineCmvnOptions``,
``OnlineCmvn`` and ``StreamingSplicer`` are host numpy, verbatim;
``OnlineFeaturePipeline`` passes ``device`` (and the generator) to its
base feature, and serves CMVN + deltas incrementally: each call costs
the frames new since the last one and the range asked for, where the
JAX package's recomputes the whole stream (ROADMAP 3.26).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_cnn_tpu_torch.core.config import configclass
from kaldi_cnn_tpu_torch.core.rng import torch_generator
from kaldi_cnn_tpu_torch.features import functional as F
from kaldi_cnn_tpu_torch.ops.fbank import fbank, mfcc


class OnlineBaseFeature:
    """Streaming fbank/MFCC (ref: OnlineGenericBaseFeature<C>)."""

    def __init__(self, kind: str = "mfcc", opts=None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.kind = kind
        self.device = torch.device(device)
        self.generator = generator or torch_generator(0, "online_dither")
        if opts is None:
            opts = F.MfccOptions() if kind == "mfcc" else F.FbankOptions()
            # streaming defaults to no dither (reproducibility); a
            # caller-provided opts keeps its own dither setting (e.g.
            # online2-wav-latgen --dither)
            opts.frame_opts.dither = 0.0
        self.opts = opts
        self._wave = np.zeros(0, np.float32)
        self._feats: List[np.ndarray] = []
        self._done = 0  # frames computed so far
        self.input_finished = False

    @property
    def frame_shift(self) -> int:
        return self.opts.frame_opts.window_shift

    def accept_waveform(self, chunk: np.ndarray) -> None:
        assert not self.input_finished
        self._wave = np.concatenate(
            [self._wave, np.asarray(chunk, np.float32)])
        self._compute_ready()

    def finish(self) -> None:
        self.input_finished = True

    def _compute_ready(self) -> None:
        fo = self.opts.frame_opts
        ready = F.num_frames(len(self._wave), fo)
        if ready <= self._done:
            return
        # frame t covers samples [t*shift, t*shift + window)
        start = self._done * fo.window_shift
        end = (ready - 1) * fo.window_shift + fo.window_size
        piece = torch.as_tensor(self._wave[start:end], device=self.device)
        fn = mfcc if self.kind == "mfcc" else fbank
        with torch.no_grad():
            feats = fn(piece, self.opts, self.generator).cpu().numpy()
        assert feats.shape[0] == ready - self._done, \
            (feats.shape, ready, self._done)
        self._feats.append(feats)
        self._done = ready

    def num_frames_ready(self) -> int:
        return self._done

    def get_frames(self, begin: int, end: int) -> np.ndarray:
        all_f = (np.concatenate(self._feats) if self._feats
                 else np.zeros((0, 1), np.float32))
        return all_f[begin:end]


@configclass
class OnlineCmvnOptions:
    cmn_window: int = 600
    min_window: int = 100
    normalize_variance: bool = False


class OnlineCmvn:
    """Causal sliding-window CMVN (ref: online-feature.cc OnlineCmvn:
    stats over up to cmn_window most recent frames; below min_window
    frames the window keeps growing from 0)."""

    def __init__(self, opts: Optional[OnlineCmvnOptions] = None,
                 global_stats: Optional[np.ndarray] = None):
        self.opts = opts or OnlineCmvnOptions()
        self.global_stats = global_stats  # [2, D+1] fallback prior
        self._frozen: Optional[np.ndarray] = None

    def freeze(self, mean: np.ndarray) -> None:
        """(ref: OnlineCmvn::Freeze — e.g. after speaker adaptation)."""
        self._frozen = mean

    def apply(self, feats: np.ndarray, upto: Optional[int] = None
              ) -> np.ndarray:
        """Normalize feats[:upto] causally."""
        out = np.asarray(feats, np.float32).copy()
        T = out.shape[0] if upto is None else upto
        csum = np.cumsum(out[:T], axis=0)
        for t in range(T):
            if self._frozen is not None:
                out[t] -= self._frozen
                continue
            lo = max(0, t + 1 - self.opts.cmn_window)
            n = t + 1 - lo
            s = csum[t] - (csum[lo - 1] if lo > 0 else 0.0)
            if n < self.opts.min_window and self.global_stats is not None:
                # blend with global prior stats
                gn = self.global_stats[0, -1]
                gs = self.global_stats[0, :-1]
                need = self.opts.min_window - n
                w = min(need, gn)
                mean = (s + gs / max(gn, 1e-8) * w) / (n + w)
            else:
                mean = s / n
            out[t] -= mean
        return out[:T]


class OnlineFeaturePipeline:
    """base features -> online CMVN -> deltas, served causally with the
    delta right-context lag (ref: OnlineNnet2FeaturePipeline without the
    iVector branch; add_ivector wires OnlineIvectorFeature in)."""

    def __init__(self, kind: str = "mfcc", opts=None,
                 cmvn: Optional[OnlineCmvn] = None,
                 deltas_order: int = 2, delta_window: int = 2,
                 device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.base = OnlineBaseFeature(kind, opts, device, generator)
        self.cmvn = cmvn or OnlineCmvn()
        self.deltas_order = deltas_order
        self.delta_window = delta_window
        # get_frames' state: the base frames taken so far (and how many of
        # the base feature's pieces), their CMVN-normalized rows and the
        # running sums of the raw ones
        self._raw = np.zeros((0, 1), np.float32)
        self._pieces = 0
        self._normed = np.zeros((0, 1), np.float32)
        self._csum = np.zeros((0, 1), np.float32)
        self.frames_normalized = 0

    @property
    def right_context(self) -> int:
        return self.deltas_order * self.delta_window

    def accept_waveform(self, chunk: np.ndarray) -> None:
        self.base.accept_waveform(chunk)

    def finish(self) -> None:
        self.base.finish()

    def num_frames_ready(self) -> int:
        n = self.base.num_frames_ready()
        if self.base.input_finished:
            return n
        return max(0, n - self.right_context)

    def get_frames(self, begin: int, end: int) -> np.ndarray:
        """Rows [begin, end) of CMVN + deltas over every base frame
        ready, as ``OnlineCmvn.apply`` and the deltas over the whole
        stream give them, at a cost bounded by the range and the frames
        new since the last call (ROADMAP 3.26; the JAX package
        recomputes the whole stream on every call).  The CMVN is causal,
        so each frame is normalized once, from running sums
        (``frames_normalized`` counts them); a frozen mean applies to
        every frame, so a frozen pipeline subtracts it from the range's
        raw frames.  The deltas of the range are taken over it and
        ``right_context`` frames on either side (``_deltas``), the
        stream's first and last frames replicated as over the whole
        stream."""
        n_base = self.base.num_frames_ready()
        self._take_base(n_base)
        b, e, _ = slice(begin, end).indices(n_base)
        e = max(b, e)
        ctx = self.right_context
        lo, hi = max(0, b - ctx), min(n_base, e + ctx)
        frozen = self.cmvn._frozen
        if frozen is not None:
            normed = self._raw[lo:hi].copy()
            normed -= frozen
        else:
            self._normalize(n_base)
            normed = self._normed[lo:hi]
        if not self.deltas_order:
            return normed[b - lo:e - lo].copy()
        return _deltas(normed, self.deltas_order,
                       self.delta_window)[b - lo:e - lo]

    def _take_base(self, n_base: int) -> None:
        """The base frames not yet taken into ``_raw`` (the base feature's
        pieces, each read once)."""
        if n_base <= len(self._raw):
            return
        new = self.base._feats[self._pieces:]
        self._pieces = len(self.base._feats)
        rows = np.concatenate(new).astype(np.float32)
        self._raw = _grown(self._raw, rows)

    def _normalize(self, n: int) -> None:
        """``OnlineCmvn.apply``'s loop for frames [len(_normed), n), from
        the running cumulative sums (the same sequential float32 sums as
        its ``np.cumsum`` over the whole stream)."""
        t0 = len(self._normed)
        if n <= t0:
            return
        opts, gstats = self.cmvn.opts, self.cmvn.global_stats
        x = self._raw[t0:n]
        sums = (np.cumsum(np.concatenate([self._csum[t0 - 1:t0], x]),
                          axis=0)[1:] if t0 else np.cumsum(x, axis=0))
        csum = _grown(self._csum, sums)
        out = x.copy()
        for i, t in enumerate(range(t0, n)):
            lo = max(0, t + 1 - opts.cmn_window)
            cnt = t + 1 - lo
            s = csum[t] - (csum[lo - 1] if lo > 0 else 0.0)
            if cnt < opts.min_window and gstats is not None:
                gn = gstats[0, -1]
                gs = gstats[0, :-1]
                need = opts.min_window - cnt
                w = min(need, gn)
                mean = (s + gs / max(gn, 1e-8) * w) / (cnt + w)
            else:
                mean = s / cnt
            out[i] -= mean
        self._csum = csum
        self._normed = _grown(self._normed, out)
        self.frames_normalized += n - t0


def _deltas(feats: np.ndarray, order: int, window: int) -> np.ndarray:
    """``compute_deltas`` (regression over [-window, window], the edge
    frames replicated) as elementwise float32 sums in a fixed order, so
    that a row's value does not depend on how many rows are around it:
    the pipeline takes the deltas of a range, and ``compute_deltas``'
    einsum rounds a row otherwise in another length of input (within
    1e-7 of it on N(0, 1) rows)."""
    T = feats.shape[0]
    denom = sum(i * i for i in range(1, window + 1)) * 2
    offsets = np.arange(-window, window + 1)
    scales = (offsets / denom).astype(np.float32)
    idx = np.clip(np.arange(T)[:, None] + offsets[None, :], 0, T - 1)
    outs = [np.asarray(feats, np.float32)]
    cur = outs[0]
    for _ in range(order):
        nxt = np.zeros_like(cur)
        for j in range(len(offsets)):
            nxt += scales[j] * cur[idx[:, j]]
        outs.append(nxt)
        cur = nxt
    return np.concatenate(outs, axis=1)


def _grown(buf: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``buf`` (rows kept in a larger store) with ``rows`` appended: the
    store doubles when full, so appending T rows in pieces copies O(T)."""
    n = len(buf)
    store = getattr(buf, "base", None)
    if (store is None or store.shape[1:] != rows.shape[1:]
            or len(store) < n + len(rows) or store[:n].ctypes.data
            != buf.ctypes.data):
        store = np.empty((max(2 * (n + len(rows)), 64),) + rows.shape[1:],
                         np.float32)
        store[:n] = buf
    store[n:n + len(rows)] = rows
    return store[:n + len(rows)]


class StreamingSplicer:
    """Streaming frame splicing around an acoustic scorer, for nnet AMs
    whose input is a +-context window of feature rows (SpliceComponent
    semantics with edge-frame replication, exactly recipes' offline
    splice).  Used as the recognizer's ``loglike_fn``: buffers incoming
    rows, scores the centers whose full right context has arrived, and
    ``flush()`` drains the clipped tail at end of input — so streaming
    output is bit-identical to scoring the offline-spliced matrix
    (ref: online2's feature-pipeline lag; here the splice IS the lag)."""

    def __init__(self, fn, left: int, right: int):
        self.fn = fn
        self.left = int(left)
        self.right = int(right)
        self._rows = []
        self._n = 0
        self._emitted = 0

    def _splice(self, lo: int, hi: int) -> np.ndarray:
        if len(self._rows) > 1:
            self._rows = [np.concatenate(self._rows)]
        x = self._rows[0]
        idx = np.clip(
            np.arange(lo, hi)[:, None]
            + np.arange(-self.left, self.right + 1)[None],
            0, self._n - 1)
        return x[idx].reshape(hi - lo, -1)

    def __call__(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, np.float32)
        if rows.size:
            self._rows.append(rows)
            self._n += len(rows)
        hi = self._n - self.right
        if hi <= self._emitted:
            return np.zeros((0, 1), np.float32)
        out = self.fn(self._splice(self._emitted, hi))
        self._emitted = hi
        return out

    def flush(self) -> np.ndarray:
        """Score the final frames whose right context is now clipped."""
        if self._n == 0 or self._emitted >= self._n:
            return np.zeros((0, 1), np.float32)
        out = self.fn(self._splice(self._emitted, self._n))
        self._emitted = self._n
        return out
