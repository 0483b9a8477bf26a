"""CUDA graph capture shared by the batch search and the trainer.

``capture`` makes a ``CountedGraph`` of a body of work: a warm-up run of
the same operations goes first on a side stream, so that every lazy
initialisation (cuDNN's plans, cuBLAS's workspace, the allocator's
blocks) happens outside the capture; the tensors that the warm-up
changes (``carry``) are put back; then the body is captured into a
memory pool.

Launch counts: a kernel wrapper's ``launches`` (``ops/common.py``) goes
up by one where its wrapper launches its kernel.  The warm-up launches
its kernels for real: they stay in ``launches`` and are also added to
the wrapper's ``warmup_launches``.  The capture runs nothing on the
card, so the counts it made are taken back and kept with the graph;
every replay adds them again.  So a graphed count is the warm-ups'
launches plus, for each replay, the launches its capture recorded (not
a count read from the device).

A capture that fails raises (torch's own error, with the graph's
capture ended); the callers do not fall back to eager work.  Python's
garbage collector is held off during a capture: a collection there
could free an old graph (a net, a decoder and its graphs left in a
reference cycle), and destroying a graph is a call that a capture
forbids, so the capture would fail (torch no longer collects before a
capture by default).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Sequence, Tuple

import torch

from kaldi_cnn_tpu_torch.ops import common


class CountedGraph(torch.cuda.CUDAGraph):
    """A ``torch.cuda.CUDAGraph`` whose ``replay`` adds the kernel
    launches captured in it to their wrappers' counts."""

    launches: Tuple[Tuple[Callable, int], ...] = ()

    def replay(self) -> None:
        super().replay()
        for fn, n in self.launches:
            fn.launches += n


def warm_up(work: Callable[[], None], device,
            carry: Sequence[torch.Tensor] = ()) -> None:
    """``work()`` on a side stream, then the ``carry`` tensors (which it
    updates in place) put back as they were; its kernel launches are
    also counted in their wrappers' ``warmup_launches``."""
    counts = common.launch_counts()
    saved = [x.clone() for x in carry]
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        work()
    cur.wait_stream(side)
    for x, v in zip(carry, saved):
        x.copy_(v)
    for fn, a, b in zip(common.COUNTED, counts, common.launch_counts()):
        fn.warmup_launches += b - a


def capture_only(body: Callable[[], None], device, pool,
                 generators: Sequence[torch.Generator] = (),
                 capture_error_mode: str = "global") -> CountedGraph:
    """A ``CountedGraph`` of ``body()`` captured into ``pool``, without a
    warm-up; the counts that the capture made are taken back and kept
    with the graph, for its replays.  The CUDA
    ``generators`` that ``body`` draws from are registered with the
    graph: a replay draws from each generator's state at that time.
    ``capture_error_mode`` is ``torch.cuda.graph``'s: "thread_local"
    lets other threads make calls that a capture forbids (an NCCL
    watchdog's event queries) while this one still may not."""
    counts = common.launch_counts()
    graph = CountedGraph()
    for g in generators:
        graph.register_generator_state(g)
    collecting = gc.isenabled()
    gc.disable()        # a collection could destroy an old graph mid-capture
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode=capture_error_mode):
            body()
    finally:
        if collecting:
            gc.enable()
    after = common.launch_counts()
    common.restore_launch_counts(counts)
    graph.launches = tuple((fn, b - a) for fn, a, b in
                           zip(common.COUNTED, counts, after) if b > a)
    return graph


def capture(body: Callable[[], None], warm: Callable[[], None], device,
            pool, carry: Sequence[torch.Tensor] = ()
            ) -> Tuple[CountedGraph, float]:
    """A CUDA graph of ``body()``.  ``warm()``, a short run of the same
    operations (one frame, one step), goes first on a side stream, so
    that every lazy initialisation happens outside the capture; the
    ``carry`` tensors (which both update in place) are put back, and
    ``body`` is captured into ``pool``.  Returns (graph, seconds); the
    seconds start after the work queued before the call has ended."""
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    warm_up(warm, device, carry)
    graph = capture_only(body, device, pool)
    torch.cuda.synchronize(device)
    return graph, time.perf_counter() - t
