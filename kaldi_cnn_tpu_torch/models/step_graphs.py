"""``Nnet.train_steps`` on the card: a group of K train steps replayed
from CUDA graphs (the counterpart of the JAX package's
``_train_scan_impl``, K steps under one jit through ``lax.scan``).

Each step of a group is a replay of the graph of ``Nnet.train_step`` on
static buffers, captured once for each (K, rows, row width, storage
dtype, ..., the step's slot k in the group, the gate of every NG state
at that step) and replayed for every later group.  The gates
(``OnlineNaturalGradient._update_now``: every step in the warm-up, then
every ``update_period``-th) are decided on the host, as in
``train_step``.  A step whose gates open needs ``torch.linalg.eigh``,
which checks its result on the host and so cannot be captured.  Such a
step is cut around it (``ng_sgd.deferred_refresh``): the step's graph
runs forward, backward, every parameter update and the Gram matrices
of the states that refresh; the eighs run after its replay; a tail
graph (one a gate vector, whatever the slot) finishes those states.
Each piece reads the old parameters and states just as the whole step
does, so the bits are the step's.  A graph a step, not one a group's
refresh pattern: with groups of 8 and the NG period of 16 the pattern
falls anywhere in a group, and a graph a pattern meant 6-13 captures in
a recipe's training (my count of PR 15's recipe cells), which ate the
gain of a short run.

Everything a graph reads or writes beyond its own temporaries lives at
fixed addresses made outside any capture: the parameters (updated in
place, as in ``train_step``), the NG states' ``u``, ``d`` and ``rho``
(``StepGraphs.storage``: the caller's states are copied in at each
group, and the returned states are copies of it, so that a caller may
hand in any earlier state again), the inputs (one pinned host buffer and its device twin:
one host-to-device copy a group), the objf of each step, and each NG
state's Gram, eigenpairs and the rest of its refresh (``_Slot``, one a
state and row count).  So all graphs of a net share one memory pool,
replayed in any order.

Dropout draws from generators registered with the graphs
(``CUDAGraph.register_generator_state``): right before a step's replay
its generator takes the state of the caller's generator for that step,
and after it the caller's generator takes the state the replay left, so
a replay draws the eager step's masks and leaves the generators where
the eager step would.

Before a graph's first capture, a step of its shape (or one with a
refresh the net's slots lack) runs once on a side stream, and the
parameters and states are put back, so that lazy initialisations and
the slots' buffers happen outside the capture.  A failed capture or
replay raises; nothing falls back to the eager steps.

``Nnet.discriminative_step`` (the MMI step, which the JAX package jits
once per shape) replays these graphs too: a one-step group of its own
kind, whose staging holds x [T, D], the numerator and denominator
occupancies [T, P] and lr, and whose graphs are keyed by (rows T,
width, pdfs, gates, storage dtype, flags), so that each utterance
length is a graph of its own (rows are not padded: a padded step is
not known to give the unpadded one's bits).  It shares the storage,
the slots (by rows), the tail graphs and the pool with the train
steps.

A mode-A data-parallel step (``parallel.dp.make_dp_step``, one step a
call) replays these graphs too when its process group is an NCCL group
(``replays_collectives``): the step's all-reduces (``core/mesh.py``:
one for the objective, one for each NG-SGD update's sums) are captured
in its graph and replayed on the group's communicator, which the
warm-up step creates (NCCL makes it at a group's first collective).
The group is part of every step graph's key (backend, size, this rank's
index), and every rank captures the same collectives in the same
order, since the gates are the same on every rank.  Such a graph is
captured in "thread_local" mode: the NCCL watchdog thread queries the
events of earlier collectives while this thread captures, which the
default mode would count against the capture.  A gloo group's
collectives run on the host and cannot be captured, so a step over one
runs eagerly (``Nnet.train_steps`` dispatches by the group's backend).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kaldi_cnn_tpu_torch.core import graphs
from kaldi_cnn_tpu_torch.models.ng_sgd import (NGState, Refresh,
                                               deferred_refresh,
                                               finish_refresh)


def ng_states(opt) -> List[Tuple[str, NGState]]:
    """The NG states of an opt tree (``Nnet.init_opt``'s layout), each
    with its side ("ng_in" / "ng_out"), in a fixed order."""
    out: List[Tuple[str, NGState]] = []

    def walk(tree, side):
        if isinstance(tree, NGState):
            out.append((side, tree))
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                walk(v, side)

    walk(opt, None)
    return out


def with_states(opt, states: Sequence[NGState]):
    """``opt`` with its NG states replaced by ``states``, in
    ``ng_states``' order."""
    it: Iterator[NGState] = iter(states)

    def walk(tree):
        if isinstance(tree, NGState):
            return next(it)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(opt)


def _store(dst: NGState, src: NGState) -> None:
    """src's tensors into dst's fixed ones (nothing for a tensor that is
    already the fixed one, as a step's own states are)."""
    for a, b in zip(dst[:3], src[:3]):
        if a is not b:
            a.copy_(b)


def replays_collectives(group) -> bool:
    """Whether a step over process ``group`` (None: no group) can run as
    a CUDA graph: with no group, or over NCCL, whose collectives are
    kernels on the card.  A gloo group's run on the host."""
    return group is None or dist.get_backend(group) == "nccl"


def _group_key(group) -> Optional[tuple]:
    """(backend, size, this rank's index, the group) of a process group,
    or None."""
    if group is None:
        return None
    return (dist.get_backend(group), dist.get_world_size(group),
            dist.get_rank(group), group)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def train_parts(k: int, n: int, d: int) -> tuple:
    """A group of K train steps' inputs: xs [K, N, D] f32, labels [K, N]
    int64, weights [K, N] f32 and lrs [K] f32."""
    return (("x", torch.float32, (k, n, d)), ("y", torch.int64, (k, n)),
            ("w", torch.float32, (k, n)), ("lr", torch.float32, (k,)))


def discriminative_parts(n: int, d: int, p: int) -> tuple:
    """One discriminative step's inputs: x [1, T, D], num_post and
    den_post [1, T, P] and lr [1], all f32."""
    return (("x", torch.float32, (1, n, d)),
            ("num", torch.float32, (1, n, p)),
            ("den", torch.float32, (1, n, p)), ("lr", torch.float32, (1,)))


class _Staging:
    """A group's inputs at fixed addresses (``parts``: (name, dtype,
    shape) each), laid out in one pinned host buffer and one device
    buffer, so that a group's inputs cross in one copy."""

    def __init__(self, parts, device):
        spans, off = [], 0
        for name, dt, shape in parts:
            size = int(np.prod(shape)) * dt.itemsize
            spans.append((name, dt, shape, off, size))
            off += -(-size // 256) * 256
        self.host_raw = torch.empty(off, dtype=torch.uint8, pin_memory=True)
        self.dev_raw = torch.empty(off, dtype=torch.uint8, device=device)
        self.host, self.dev = {}, {}
        for name, dt, shape, o, size in spans:
            self.host[name] = self.host_raw[o:o + size].view(dt).view(shape)
            self.dev[name] = self.dev_raw[o:o + size].view(dt).view(shape)
        self.copied: Optional[torch.cuda.Event] = None

    def load(self, values: Dict[str, object]) -> None:
        """This group's inputs by name ([K, ...] arrays or K per-step
        arrays, numpy or tensors) into the device buffers through the
        pinned buffer, in one copy."""
        if self.copied is not None:
            self.copied.synchronize()      # the last group's copy is done
        for k, v in values.items():
            dst = self.host[k].numpy()
            if isinstance(v, (np.ndarray, torch.Tensor)):
                dst[...] = _host(v)
            else:
                for i, row in enumerate(v):
                    dst[i] = _host(row)
        self.dev_raw.copy_(self.host_raw, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()


class _Slot:
    """An NG state's refresh at fixed addresses: the state (its fixed
    storage) and ``_gram``'s m, Gram and finite flag, with eigh's
    eigenpairs of the Gram.  Each buffer keeps the strides of the tensor
    it holds (eigh's eigenvectors are column-major): a matmul of another
    layout may round otherwise, and the state would not be the eager
    step's to the bit."""

    def __init__(self, r: Refresh):
        self.ng, self.state = r.ng, r.state
        self.m = torch.empty_like(r.m)
        self.gram = torch.empty_like(r.gram)
        self.finite = torch.empty_like(r.finite)
        self.evals: Optional[torch.Tensor] = None
        self.evecs: Optional[torch.Tensor] = None

    def stash(self, r: Refresh) -> None:
        self.m.copy_(r.m)
        self.gram.copy_(r.gram)
        self.finite.copy_(r.finite)

    def eigh(self) -> None:
        evals, evecs = torch.linalg.eigh(self.gram)
        if self.evecs is None:        # the first run, before any capture
            self.evals = torch.empty_like(evals)
            self.evecs = torch.empty_like(evecs)
        self.evals.copy_(evals)
        self.evecs.copy_(evecs)

    def finish(self) -> None:
        new = finish_refresh(Refresh(self.ng, self.state, self.m, self.gram,
                                     self.finite), self.evals, self.evecs)
        _store(self.state, new)


class Plan:
    """A group's steps on tensors at fixed addresses, on any device:
    ``inputs`` (``train_parts``' x, y, w and lr: ``Nnet.train_step``; or
    ``discriminative_parts``' x, num, den and lr:
    ``Nnet.discriminative_step``), the NG states' ``storage``, each
    state's ``slots`` (by its index in ``storage``), for a net that
    draws masks one generator a step, and the process ``group`` of a
    data-parallel step (None: none).  A step runs whole, its
    refreshes held back (``step``); then the eighs and the ``tail`` of
    the states it refreshed.  ``run_eager`` runs a group so; the card
    captures ``step`` and ``tail`` as graphs."""

    def __init__(self, net, inputs: Dict[str, torch.Tensor],
                 storage: Sequence[NGState], slots: Dict[int, _Slot],
                 gens: Optional[Sequence[torch.Generator]] = None,
                 group=None):
        self.net, self.inputs, self.storage = net, inputs, storage
        self.slots, self.gens, self.group = slots, gens, group
        self.objf = torch.zeros(inputs["lr"].shape[0],
                                device=inputs["x"].device)
        self.index = {id(s.u): i for i, s in enumerate(storage)}

    def opt(self, opt, k: int):
        """``opt``'s layout on the fixed storage, the step counts + k."""
        return with_states(opt, [NGState(s.u, s.d, s.rho, o.t + k)
                                 for s, (_, o) in zip(self.storage,
                                                      ng_states(opt))])

    def step(self, k: int, opt) -> List[int]:
        """Step k of the group on ``opt`` (``Plan.opt``): parameters and
        every state whose gate is closed updated, the refreshing states'
        Grams in their slots; returns those states' indices."""
        st = self.inputs
        gen = None if self.gens is None else self.gens[k]
        with deferred_refresh() as pending:
            if "num" in st:
                new_opt, objf = self.net.discriminative_step_eager(
                    opt, st["x"][k], st["num"][k], st["den"][k], st["lr"][k],
                    generator=gen, group=self.group)
            else:
                new_opt, objf = self.net.train_step(
                    opt, st["x"][k], st["y"][k], st["lr"][k],
                    weights=st["w"][k], group=self.group, generator=gen)
        self.objf[k].copy_(objf)
        for (_, dst), (_, src) in zip(ng_states(opt), ng_states(new_opt)):
            _store(dst, src)
        refreshed = []
        for r in pending:
            i = self.index[id(r.state.u)]
            if i not in self.slots:       # outside any capture
                self.slots[i] = _Slot(r)
            self.slots[i].stash(r)
            refreshed.append(i)
        return refreshed

    def eighs(self, refreshed: Sequence[int]) -> None:
        for i in refreshed:
            self.slots[i].eigh()

    def tail(self, refreshed: Sequence[int]) -> None:
        for i in refreshed:
            self.slots[i].finish()

    def run_eager(self, opt, k_steps: Optional[Sequence[int]] = None
                  ) -> None:
        """Steps ``k_steps`` (all K by default) from ``opt``, each with its
        eighs and tail, eagerly."""
        for k in (range(len(self.objf)) if k_steps is None else k_steps):
            refreshed = self.step(k, self.opt(opt, k))
            self.eighs(refreshed)
            self.tail(refreshed)


class _Group(Plan):
    """A plan on the card: the pinned staging of its inputs (``parts``)
    and, for a net that draws masks, its generators (one a step,
    registered with that step's graphs)."""

    def __init__(self, sg: "StepGraphs", parts, k: int, n: int,
                 draws: bool, group=None):
        self.staging = _Staging(parts, sg.device)
        gens = ([torch.Generator(device=sg.device) for _ in range(k)]
                if draws else None)
        super().__init__(sg.net, self.staging.dev, sg.storage,
                         sg.slots.setdefault(n, {}), gens, group)


class StepGraphs:
    """A net's graphed train and discriminative steps: the NG states'
    fixed storage, the slots, the groups (staging and plan) by (kind,
    K, rows, width, whether masks are drawn, process group[, pdfs]),
    the graphs, and the memory pool they share.  A deep copy or a pickle
    of the net gets none of it (a copy captures its own)."""

    def __init__(self, net):
        self.net = net
        self.device = net.device
        self.pool = torch.cuda.graph_pool_handle()
        self.storage: List[NGState] = []
        self.slots: Dict[int, Dict[int, _Slot]] = {}
        self.groups: Dict[tuple, _Group] = {}
        self.graphs: Dict[tuple, graphs.CountedGraph] = {}
        self.refreshed: Dict[tuple, List[int]] = {}
        self.warmed: set = set()
        self.capture_s: Dict[tuple, float] = {}
        self.addresses: tuple = ()

    def __deepcopy__(self, memo):
        return None

    def __reduce__(self):
        return (type(None), ())

    def _addresses(self) -> tuple:
        return tuple(t.data_ptr() for t in self.net.parameters()) + tuple(
            t.data_ptr() for t in self.net.buffers())

    def _bind(self, states: List[NGState]) -> None:
        """The caller's NG states into the fixed storage (made anew, and
        every graph, group and slot dropped, when the states' shapes or
        the parameters' addresses changed)."""
        shapes = [tuple(x.shape for x in s[:3]) for s in states]
        addresses = self._addresses()
        if (addresses != self.addresses or shapes != [
                tuple(x.shape for x in s[:3]) for s in self.storage]):
            self.graphs.clear()
            self.groups.clear()
            self.slots.clear()
            self.refreshed.clear()
            self.warmed.clear()
            self.addresses = addresses
            self.storage = [NGState(s.u.clone(), s.d.clone(),
                                    s.rho.clone(), s.t) for s in states]
            return
        for dst, src in zip(self.storage, states):
            _store(dst, src)

    def _warm(self, group: _Group, k: int, opt, shape: tuple,
              gates: tuple) -> None:
        """Step k run once on a side stream, parameters and states put
        back, when its shape has not run yet or it refreshes a state
        that has no slot yet."""
        slots = group.slots
        missing = any(g and i not in slots for i, g in enumerate(gates))
        if shape in self.warmed and not missing:
            return
        carry = list(self.net.parameters()) + [
            x for s in self.storage for x in s[:3]]
        graphs.warm_up(lambda: group.run_eager(opt, [k]), self.device,
                       carry)
        self.warmed.add(shape)

    def _graph(self, key: tuple, body, drawn=(),
               mode: str = "global") -> graphs.CountedGraph:
        g = self.graphs.get(key)
        if g is None:
            t = time.perf_counter()
            g = self.graphs[key] = graphs.capture_only(
                body, self.device, self.pool, drawn, mode)
            self.capture_s[key] = time.perf_counter() - t
        return g

    def _plan(self, gkey: tuple, parts, k_steps: int, n: int, draws: bool,
              group) -> _Group:
        plan = self.groups.get(gkey)
        if plan is None:
            plan = self.groups[gkey] = _Group(self, parts, k_steps, n,
                                              draws, group)
        return plan

    def run(self, opt, xs, labels, lrs, weights, generators,
            store_dtype, group=None) -> Tuple:
        """``Nnet.train_steps`` on the card (lrs a float32 array [K]),
        each step over process ``group`` (an NCCL group, or None)."""
        self._bind([s for _, s in ng_states(opt)])
        k_steps, n, d = len(lrs), len(labels[0]), self.net.input_dim
        draws = generators is not None and self.net.draws_masks()
        gkey = ("train", k_steps, n, d, draws, _group_key(group))
        plan = self._plan(gkey, train_parts(k_steps, n, d), k_steps, n,
                          draws, group)
        plan.staging.load({"x": xs, "y": labels, "w": weights, "lr": lrs})
        return self._steps(plan, gkey, opt, generators, draws, store_dtype,
                           group)

    def run_discriminative(self, opt, x, num_post, den_post, lr, generator,
                           store_dtype, group=None) -> Tuple:
        """``Nnet.discriminative_step`` on the card: a one-step group of
        its own kind, a graph a (rows, pdfs, gates, ...)."""
        self._bind([s for _, s in ng_states(opt)])
        (n, d), p = tuple(x.shape), int(num_post.shape[1])
        draws = generator is not None and self.net.draws_masks()
        gkey = ("disc", 1, n, d, draws, _group_key(group), p)
        plan = self._plan(gkey, discriminative_parts(n, d, p), 1, n, draws,
                          group)
        plan.staging.load({"x": [x], "num": [num_post], "den": [den_post],
                           "lr": np.asarray([lr], np.float32)})
        opt, objf = self._steps(plan, gkey, opt,
                                None if generator is None else [generator],
                                draws, store_dtype, group)
        return opt, objf[0]

    def _steps(self, plan: _Group, gkey: tuple, opt, generators, draws,
               store_dtype, group) -> Tuple:
        """The group's steps as replays, each graph captured at its first
        use; returns (opt', objf per step)."""
        net = self.net
        sides = ng_states(opt)
        ts = [s.t for _, s in sides]
        k_steps, n = gkey[1], gkey[2]
        mode = "global" if group is None else "thread_local"
        shape = (n, gkey[3], store_dtype,
                 torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.get_float32_matmul_precision())
        for k in range(k_steps):
            gates = tuple((net.ng_in if side == "ng_in" else net.ng_out)
                          ._update_now(t + k)
                          for (side, _), t in zip(sides, ts))
            skey = ("step", gkey, k, gates) + shape
            if skey not in self.graphs:
                self._warm(plan, k, opt, gkey[:1] + shape, gates)

                def body(k=k, skey=skey):
                    self.refreshed[skey] = plan.step(k, plan.opt(opt, k))

                self._graph(skey, body,
                            [] if plan.gens is None else [plan.gens[k]],
                            mode)
            if draws:       # after any warm-up, which draws from it too
                plan.gens[k].set_state(generators[k].get_state())
            self.graphs[skey].replay()
            if draws:
                generators[k].set_state(plan.gens[k].get_state())
            if any(gates):
                refreshed = self.refreshed[skey]
                plan.eighs(refreshed)
                self._graph(("tail", n, gates) + shape,
                            lambda: plan.tail(refreshed)).replay()
        out = with_states(opt, [NGState(s.u.clone(), s.d.clone(),
                                        s.rho.clone(), t + k_steps)
                                for s, t in zip(self.storage, ts)])
        return out, plan.objf.clone()

    @property
    def capture_seconds(self) -> Dict[tuple, float]:
        """Seconds of each graph's capture: ("step", K, rows, slot k,
        refreshes), ("disc", rows, refreshes) and ("tail", rows); a
        data-parallel step's key ends with its group's (backend, size,
        rank)."""
        out = {}
        for key, v in self.capture_s.items():
            if key[0] == "step":
                kind, k_steps, n, _, _, pg = key[1][:6]
                head = (("step", k_steps, n, key[2]) if kind == "train"
                        else ("disc", n))
                out[head + (any(key[3]),)
                    + (() if pg is None else (pg[:3],))] = v
            else:
                out[("tail", key[1])] = v
        return out
