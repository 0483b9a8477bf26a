"""Online natural-gradient SGD preconditioner (twin of
``kaldi_cnn_tpu/models/ng_sgd.py``; ref: src/nnet2/
nnet-precondition-online.{h,cc}).

Per affine-like layer and per side (input rows / output-derivative rows)
an online low-rank-plus-isotropic estimate of the uncentered covariance

    F ~ U^T diag(d) U + rho (I - U^T U),   U: [R, D] orthonormal rows,

preconditions each minibatch's row space by the damped inverse of F,
rescaled to keep the Frobenius norm.  The algebra is the JAX package's,
step for step.  Two things differ by design:

* The state's step count ``t`` is a host integer, so the update gate
  (every step during warm-up, then every ``update_period``-th) is decided
  on the host; the JAX package evaluates it on the device under
  ``lax.cond``.  A device count would cost one ``.item()`` per step and
  layer.
* ``torch.linalg.eigh`` returns eigenvectors up to sign, and cuSOLVER and
  LAPACK may pick other signs than JAX; every use of ``u`` here is
  invariant to them, so states are compared through the projector
  ``u^T diag(d) u`` and ``rho``.
* The update is two halves around its eigh (``_gram``, ``_finish``), so
  that ``deferred_refresh`` can hold the eigh back: torch's eigh checks
  its result on the host, and a step captured as a CUDA graph runs it
  between two graphs (``models/step_graphs.py``).

Data parallelism (mode A): with a process ``group``, each rank holds an
equal row slice of the global minibatch, in rank order.  Every sum over
rows (the gradient, the norms, the projections' column sums) is summed
over the group, and the strided row sample is taken over the GLOBAL
rows and assembled from the ranks that own them, so that every rank
computes the single-process update of the global batch, and all ranks
the same bits.  ``group=None`` is the single-process path.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import torch

from kaldi_cnn_tpu_torch.core.mesh import reduce_sum, row_span, strided_rows


class NGState(NamedTuple):
    u: torch.Tensor     # [R, D] orthonormal rows
    d: torch.Tensor     # [R] eigenvalues (>= rho)
    rho: torch.Tensor   # scalar, remainder eigenvalue
    t: int              # step count (host)


class Refresh(NamedTuple):
    """A state update held back by ``deferred_refresh``: the
    preconditioner, the state it updates, and ``_gram``'s (m, f64 Gram,
    finite)."""
    ng: "OnlineNaturalGradient"
    state: NGState
    m: torch.Tensor
    gram: torch.Tensor
    finite: torch.Tensor


# the open list of deferred_refresh, or None
_DEFERRED: Optional[List[Refresh]] = None


@contextlib.contextmanager
def deferred_refresh():
    """Within the block, every state update whose gate is open stops
    before its eigendecomposition: it appends a ``Refresh`` to the list
    this yields and leaves the state's tensors as they were.  The caller
    finishes each one with ``finish_refresh``.  A step's parameter
    updates read only the old states, so a step run this way and its
    refreshes finished after it give the bits of the step run whole.
    It is how a training step is cut around ``torch.linalg.eigh``, which
    checks its result on the host and so cannot run inside a CUDA
    graph."""
    global _DEFERRED
    outer, _DEFERRED = _DEFERRED, []
    try:
        yield _DEFERRED
    finally:
        _DEFERRED = outer


def finish_refresh(r: Refresh, evals: torch.Tensor, evecs: torch.Tensor
                   ) -> NGState:
    """The updated state of a deferred refresh, from
    ``torch.linalg.eigh(r.gram)``."""
    return r.ng._finish(r.state, r.m, r.finite, evals, evecs)


class OnlineNaturalGradient:
    """One instance per (layer, side); ``state`` is an ``NGState``."""

    def __init__(self, rank: int = 40, eta: float = 0.1,
                 alpha: float = 4.0, update_period: int = 1,
                 warmup_updates: int = 64):
        self.rank = rank
        self.eta = eta
        self.alpha = alpha
        self.update_period = update_period
        self.warmup_updates = warmup_updates

    def _update_now(self, t: int) -> bool:
        return t < self.warmup_updates or t % self.update_period == 0

    def init(self, dim: int, device="cuda") -> NGState:
        r = min(self.rank, max(dim - 1, 1))
        return NGState(u=torch.eye(r, dim, device=device),
                       d=torch.ones(r, device=device),
                       rho=torch.ones((), device=device), t=0)

    def factors(self, state: NGState
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(a, c, u) with x_hat = a*x + ((x @ u^T) * c) @ u."""
        u, d, rho = state.u, state.d, state.rho
        dim = u.shape[1]
        tr = d.sum() + rho * (dim - d.shape[0])
        damp = self.alpha * tr / dim
        a = 1.0 / (rho + damp)
        c = 1.0 / (d + damp) - a
        return a, c, u

    def gamma(self, a, c, x_sq, proj_sq) -> torch.Tensor:
        """Norm-preserving rescale of the factored form (u orthonormal)."""
        den = a * a * x_sq + ((2.0 * a * c + c * c) * proj_sq).sum()
        return torch.sqrt((x_sq + 1e-20) / (den + 1e-20))

    def maybe_update_from_sample(self, state: NGState, xs: torch.Tensor,
                                 x_energy: torch.Tensor) -> NGState:
        """The gated state update from sampled rows xs [s, D] and the
        batch's mean row energy ||X||^2 / N.  Inside ``deferred_refresh``
        an open gate only records the update's eigenproblem and returns
        the old tensors with the step counted."""
        if not self._update_now(state.t):
            return state._replace(t=state.t + 1)
        if _DEFERRED is not None:
            _DEFERRED.append(
                Refresh(self, state, *self._gram(state, xs, x_energy)))
            return state._replace(t=state.t + 1)
        return self._update_from_sample(state, xs, x_energy)

    def _update_from_sample(self, state: NGState, xs: torch.Tensor,
                            x_energy: torch.Tensor) -> NGState:
        """Track the top-R eigenbasis of (1-eta) F + eta X^T X / N."""
        m, gram, finite = self._gram(state, xs, x_energy)
        evals, evecs = torch.linalg.eigh(gram)            # ascending
        return self._finish(state, m, finite, evals, evecs)

    def _gram(self, state: NGState, xs: torch.Tensor,
              x_energy: torch.Tensor):
        """The update's first half: (m [R+s, D], the f64 Gram m m^T
        that eigh takes, whether m m^T was finite)."""
        xs = xs.to(torch.float32)
        u, d, rho = state.u, state.d, state.rho
        s = xs.shape[0]
        xs_energy = (xs * xs).sum() / s + 1e-20
        xs = xs * torch.sqrt(x_energy / xs_energy)
        m = torch.cat([
            max(1.0 - self.eta, 0.0) ** 0.5
            * torch.sqrt(torch.clamp_min(d - rho, 0.0))[:, None] * u,
            (self.eta / s) ** 0.5 * xs,
        ])                                                # [R+s, D]
        gram = m @ m.T
        # torch's eigh raises where jnp's returns NaN: hand it a finite
        # matrix and let the guard in _finish keep the old state.  It runs
        # in f64: LAPACK's f32 solver fails to converge on the near-zero,
        # degenerate Gram of a batch whose derivative rows are mostly 0
        # (zero-weight padding), where jnp's returns garbage silently.
        finite = torch.isfinite(gram).all()
        gram = torch.where(finite, gram, torch.eye(
            gram.shape[0], device=gram.device))
        return m, gram.double(), finite

    def _finish(self, state: NGState, m: torch.Tensor, finite: torch.Tensor,
                evals: torch.Tensor, evecs: torch.Tensor) -> NGState:
        """The update's second half, from eigh's (ascending) f64
        eigenvalues and eigenvectors of ``_gram``'s matrix."""
        u, d, rho = state.u, state.d, state.rho
        r, dim = u.shape
        evals, evecs = evals.float(), evecs.float()
        evals = torch.clamp_min(evals.flip(0), 0.0)
        evecs = evecs.flip(1)
        top_vals = evals[:r]
        basis = evecs[:, :r].T @ m                        # [R, D]
        norms = torch.sqrt((basis * basis).sum(dim=1, keepdim=True))
        u_new = basis / torch.clamp_min(norms, 1e-8)
        rho_base = (1.0 - self.eta) * rho + self.eta * 1e-3
        rest = torch.clamp_min(evals.sum() - top_vals.sum(), 0.0)
        rho_new = rho_base + rest / dim
        d_new = top_vals + rho_new
        # keep the old state on a degenerate batch (a device-side select)
        ok = (finite & torch.isfinite(d_new).all()
              & torch.isfinite(u_new).all())
        return NGState(u=torch.where(ok, u_new, u),
                       d=torch.where(ok, d_new, d),
                       rho=torch.where(ok, rho_new, rho), t=state.t + 1)

    def sample_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic-stride sample of <= R rows."""
        return strided_rows(x, x.shape[0], self.rank, 0)

    def _precondition_given(self, state: NGState, x: torch.Tensor,
                            x_sq=None, group=None) -> torch.Tensor:
        """x_sq: ||x||^2 over the group's rows, when already summed."""
        a, c, u = self.factors(state)
        x_hat = x * a + ((x @ u.T) * c) @ u
        if x_sq is None:
            (x_sq,) = reduce_sum([(x * x).sum()], group)
        (h_sq,) = reduce_sum([(x_hat * x_hat).sum()], group)
        num = torch.sqrt(x_sq + 1e-20)
        den = torch.sqrt(h_sq + 1e-20)
        return x_hat * (num / den)

    def precondition(self, state: NGState, x: torch.Tensor, group=None
                     ) -> Tuple[torch.Tensor, NGState]:
        """Returns (preconditioned rows, updated state); with a group,
        ``x`` is this rank's row slice and the statistics are the
        group's."""
        x = x.to(torch.float32)
        offset, n = row_span(x.shape[0], group)
        x_sq, xs = reduce_sum([(x * x).sum(), strided_rows(
            x, n, self.rank, offset, group)], group)
        new_state = self.maybe_update_from_sample(state, xs, x_sq / n)
        return self._precondition_given(state, x, x_sq, group), new_state


def ng_delta_from_stats(ng_in: OnlineNaturalGradient,
                        ng_out: OnlineNaturalGradient,
                        state_in: NGState, state_out: NGState,
                        g: torch.Tensor, x_sq, proj_sq_in, d_sq,
                        proj_sq_out, xs: torch.Tensor, ds: torch.Tensor,
                        n_rows: float
                        ) -> Tuple[torch.Tensor, NGState, NGState]:
    """Preconditioned delta from sufficient statistics of the row spaces:
    g = d^T x [out, in], x_sq / d_sq = squared Frobenius norms,
    proj_sq_* [R] = column sums of squared projections on the old bases,
    xs / ds the sampled rows for the state updates, n_rows the row count."""
    a_i, c_i, u_i = ng_in.factors(state_in)
    a_o, c_o, u_o = ng_out.factors(state_out)
    gu_i = g @ u_i.T                               # [out, Ri]
    uo_g = u_o @ g                                 # [Ro, in]
    uo_g_ui = u_o @ gu_i                           # [Ro, Ri]
    delta = ((a_o * a_i) * g
             + a_o * (gu_i * c_i) @ u_i
             + a_i * u_o.T @ (c_o[:, None] * uo_g)
             + u_o.T @ ((c_o[:, None] * uo_g_ui) * c_i) @ u_i)
    gamma_in = ng_in.gamma(a_i, c_i, x_sq, proj_sq_in)
    gamma_out = ng_out.gamma(a_o, c_o, d_sq, proj_sq_out)
    delta = delta * (gamma_in * gamma_out)
    new_in = ng_in.maybe_update_from_sample(state_in, xs, x_sq / n_rows)
    new_out = ng_out.maybe_update_from_sample(state_out, ds, d_sq / n_rows)
    return delta, new_in, new_out


def ng_affine_apply(ng_in: OnlineNaturalGradient,
                    ng_out: OnlineNaturalGradient,
                    state_in: NGState, state_out: NGState,
                    x: torch.Tensor, d: torch.Tensor,
                    w: torch.Tensor, b: torch.Tensor, lr: float,
                    max_change: float, group=None,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, NGState, NGState]:
    """Factored NG-SGD update of an affine layer: the same as
    ``fused_ng_delta([x|1], d)`` + max-change clip + apply, with the bias
    column handled analytically and the [out, in] delta never formed.
    Returns (w', b', state_in', state_out'); statistics accumulate in
    f32 whatever the stored dtype of x and d.  With a group, x and d are
    this rank's rows and the row sums and samples the group's, in one
    all-reduce.  ``rows`` = (lo, hi): w and b are rows [lo, hi) of the
    layer (a tensor-parallel shard) while d has all its columns; the
    preconditioners and the max-change norm see the whole layer, and
    only those rows are updated."""
    offset, n = row_span(x.shape[0], group)
    x32, d32 = x.to(torch.float32), d.to(torch.float32)
    u_i, u_o = state_in.u, state_out.u
    u_iw, u_ib = u_i[:, :-1], u_i[:, -1]
    a_i, c_i, _ = ng_in.factors(state_in)
    a_o, c_o, _ = ng_out.factors(state_out)
    p_in = x32 @ u_iw.T + u_ib[None, :]                 # [N, Ri]
    p_out = d32 @ u_o.T                                 # [N, Ro]
    g_w, g_b, x_sq, d_sq, pp_in, pp_out, xs, ds = reduce_sum([
        d32.T @ x32, d32.sum(dim=0),
        (x32 * x32).sum() + x.shape[0],                 # + ones column
        (d32 * d32).sum(), (p_in * p_in).sum(dim=0),
        (p_out * p_out).sum(dim=0),
        strided_rows(x32, n, ng_in.rank, offset, group),
        strided_rows(d, n, ng_out.rank, offset, group)], group)
    gamma_in = ng_in.gamma(a_i, c_i, x_sq, pp_in)
    gamma_out = ng_out.gamma(a_o, c_o, d_sq, pp_out)
    gu_i = g_w @ u_iw.T + g_b[:, None] * u_ib[None, :]  # [out, Ri]
    uo_gw = u_o @ g_w                                   # [Ro, in]
    uo_gb = u_o @ g_b                                   # [Ro]
    uo_g_ui = u_o @ gu_i                                # [Ro, Ri]
    A = a_o * a_i
    P = a_o * (gu_i * c_i)                              # [out, Ri]
    M = c_o[:, None] * uo_g_ui * c_i[None, :]           # [Ro, Ri]
    q_w = a_i * (c_o[:, None] * uo_gw) + M @ u_iw       # [Ro, in]
    q_b = a_i * (c_o * uo_gb) + M @ u_ib                # [Ro]
    gamma = gamma_in * gamma_out
    if max_change > 0:
        # ||delta||_F^2 from the factors (u_i / u_o rows orthonormal)
        g_sq = (g_w * g_w).sum() + (g_b * g_b).sum()
        q_sq = (q_w * q_w).sum() + (q_b * q_b).sum()
        uo_g_ext = (q_w * uo_gw).sum() + (q_b * uo_gb).sum()
        cross_pq = ((u_o @ P) * (q_w @ u_iw.T
                                 + q_b[:, None] * u_ib[None, :])).sum()
        nrm_sq = (A * A * g_sq + (P * P).sum() + q_sq
                  + 2.0 * A * (P * gu_i).sum()
                  + 2.0 * A * uo_g_ext
                  + 2.0 * cross_pq)
        norm = torch.sqrt(torch.clamp_min(nrm_sq, 0.0)) * gamma * abs(lr)
        scale = torch.clamp_max(max_change / torch.clamp_min(norm, 1e-20),
                                1.0)
    else:
        scale = 1.0
    step = lr * scale * gamma
    r = slice(None) if rows is None else slice(*rows)
    w_new = w + step * (A * g_w[r] + P[r] @ u_iw + u_o.T[r] @ q_w)
    b_new = b + step * (A * g_b[r] + P[r] @ u_ib + u_o.T[r] @ q_b)
    xs = torch.cat([xs, xs.new_ones((xs.shape[0], 1))], dim=1)
    new_in = ng_in.maybe_update_from_sample(state_in, xs, x_sq / n)
    new_out = ng_out.maybe_update_from_sample(state_out, ds, d_sq / n)
    return w_new, b_new, new_in, new_out


def fused_ng_delta(ng_in: OnlineNaturalGradient,
                   ng_out: OnlineNaturalGradient,
                   state_in: NGState, state_out: NGState,
                   x: torch.Tensor, d: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, NGState, NGState]:
    """delta = precondition(d)^T @ precondition(x) without forming either
    preconditioned [N, dim] matrix.  Returns (delta [out, in],
    state_in', state_out').  With a group, x and d are this rank's rows
    and the statistics the group's."""
    offset, n = row_span(x.shape[0], group)
    x32, d32 = x.to(torch.float32), d.to(torch.float32)
    p_in = x32 @ state_in.u.T
    p_out = d32 @ state_out.u.T
    stats = reduce_sum([
        d32.T @ x32, (x32 * x32).sum(), (p_in * p_in).sum(dim=0),
        (d32 * d32).sum(), (p_out * p_out).sum(dim=0),
        strided_rows(x, n, ng_in.rank, offset, group),
        strided_rows(d, n, ng_out.rank, offset, group)], group)
    return ng_delta_from_stats(ng_in, ng_out, state_in, state_out, *stats,
                               n)
