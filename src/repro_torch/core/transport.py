"""Pluggable transport layer — the parameter-server snapshot/commit protocol.

The paper's parameter-server paradigm is a *protocol*, not an execution
substrate: workers solve local dual subproblems against a bounded-stale
snapshot of ``(W, Sigma)`` and exchange only ``(delta_w, Sigma)``-shaped
messages with the server (arXiv:1609.09563, arXiv:1802.03830 make the same
split for their async/graph-regularized variants). This module is that
protocol behind one surface, so the same driver (``fit_async``) runs over
any substrate:

    spec = get_transport("simulated" | "threaded" | "multiprocess" | "gossip")

Protocol (the ``Transport`` base class)
---------------------------------------
Worker-facing primitives:

  * ``gate(worker, round) -> bool``       SSP admission: may ``worker``
    start ``round``?  True iff ``round <= min(completed) + tau``.  Host
    transports BLOCK until the gate opens.
  * ``snapshot(worker) -> Snapshot``      versioned read of the worker's
    ``(W_rows, sigma_rows, alpha_rows)`` — the solve it later commits is
    computed against exactly this snapshot.
  * ``commit(worker, round, delta) -> CommitReceipt``  apply one worker's
    ``(dalpha_rows, db_rows)`` to the server state; the receipt carries the
    observed staleness (server commits between snapshot and apply) and lag
    (rounds ahead of the slowest worker at start).
  * ``install_sigma(sigma, omega, defer=...)``  Omega-step result install;
    with ``defer=True`` it lands only after ``cfg.omega_delay`` commits of
    the next W-step (overlapped Omega-step), else immediately.

Driver-facing lifecycle: ``setup`` / ``run_w_step`` / ``w_true`` /
``pad_sigma`` / ``result`` / ``close``, plus clock/staleness introspection
(``clock()``, ``staleness()``).  All staleness/lag accounting flows through
one path: ``CommitReceipt -> record_receipt -> history ->
convergence.staleness_summary``.

Members
-------
``threaded``      a real in-host parameter server: the server state lives
                  behind a lock/condition pair, G worker *threads* gate,
                  snapshot, solve and commit concurrently.  Arrival order
                  is genuinely nondeterministic but SSP-gate-correct
                  (observed lag can never exceed tau).  ``async_delays``
                  become sleep pacing so straggler schedules remain
                  expressible.
``multiprocess``  the same server state machine, with G worker *processes*
                  (fresh interpreters that import this package only)
                  driving it over length-prefixed pickle frames on a
                  loopback socket (one handler thread per connection): the
                  cross-host RPC shape with the host boundary faked by
                  localhost.  Trusted-local only: pickle framing is not an
                  authentication boundary.
``gossip``        (``core/gossip.py``) serverless neighbor averaging over a
                  configurable topology.
``simulated``     deterministic per-worker clocks over a mesh
                  (``core/distributed.py``): virtual workers advance on
                  simulated ticks, every commit event runs one masked SPMD
                  tick (``make_async_tick``), and runs repeat exactly
                  (golden event histories in ``tests/golden/``).

Wire formats (``core/wire.py``): ``cfg.codec`` picks the snapshot/commit
codec (``none`` / ``bf16`` / ``int8`` + error feedback); the multiprocess
frames carry a version byte so protocol skew raises
``TransportProtocolError``.

Device and host. The server's state (alpha, W, Sigma) lives on the run's
device, the card unless the caller asks for the CPU. The wire is numpy:
a snapshot crosses it as host arrays, and so does a commit under a lossy
codec or between processes. JAX arrays are immutable and the JAX server
relies on it (a snapshot is a view of the round boundary's W); here every
update of the server state is made out of place (``self.W = self.W +
...``), never in place, so the boundary, the snapshots and the
subscribers' arrays are never written after they are handed out.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import prng
from . import convergence as conv_mod
from . import dual as dual_mod
from . import omega as omega_mod
from .distributed import (
    DistributedState,
    MeshAxes,
    MeshRun,
    _axis_size,
    _densify_pair,
    make_local_solve,
    on_root,
    pad_sigma_any,
    pad_to_multiple,
    server_reduce,
)
from .dmtrl import DMTRLConfig, _rho_value, resolve_device
from .losses import get_loss
from .sigma_view import SigmaView, maybe_dense
from .solver_backends import draw_task_uniform, get_backend
from .wire import (
    WIRE_VERSION,
    Codec,
    Encoded,
    ErrorFeedback,
    check_wire_version,
    get_codec,
)
from ..obs.trace import span

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

# sleep pacing of one delay tick for the host transports (so the
# async_delays straggler schedules remain meaningful under real clocks)
PACE_SECONDS = 0.005

# ---------------------------------------------------------------------------
# unified wire_stats schema
# ---------------------------------------------------------------------------
# ONE key union across every transport, so dashboards and the obs bridge
# (obs.metrics.publish_wire_stats) never KeyError on a transport switch.
# Gossip-only keys (topology / spectral_gap / n_exchanges / *mix_bytes) are
# present everywhere with inert defaults; star transports never move them.
WIRE_STATS_SCHEMA: Dict[str, object] = {
    "codec": "none",  # wire codec name (str label, not a counter)
    "topology": "star",  # neighbor graph; "star" = parameter server
    "spectral_gap": 0.0,  # mixing-matrix contraction rate (gossip)
    "n_snapshots": 0,
    "n_commits": 0,
    "n_exchanges": 0,  # gossip edge exchanges
    "snapshot_bytes": 0,  # bytes actually shipped per snapshot
    "commit_bytes": 0,  # bytes actually shipped per delta_w
    "mix_bytes": 0,  # gossip neighbor-exchange bytes
    "raw_snapshot_bytes": 0,  # what the none codec would have sent
    "raw_commit_bytes": 0,
    "raw_mix_bytes": 0,
}


def new_wire_stats(**overrides) -> Dict[str, object]:
    """A fresh ``wire_stats`` dict carrying the full unified schema.

    ``overrides`` must stay inside the documented key union — a typo'd
    counter name here would silently fork the schema, so it raises."""
    unknown = set(overrides) - set(WIRE_STATS_SCHEMA)
    if unknown:
        raise ValueError(
            f"unknown wire_stats key(s) {sorted(unknown)}; the schema is "
            f"{sorted(WIRE_STATS_SCHEMA)}"
        )
    ws = dict(WIRE_STATS_SCHEMA)
    ws.update(overrides)
    return ws


def _host(a) -> np.ndarray:
    """A tensor's values as a host numpy array (a copy off the card; on the
    CPU a view, which is safe because the server never updates in place)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _add_rows(a: Tensor, rows: slice, v: Tensor) -> Tensor:
    """A new tensor equal to ``a`` with ``v`` added to its rows ``rows``
    (the server's updates never write the tensors it handed out)."""
    return torch.cat([a[: rows.start], a[rows] + v, a[rows.stop :]], dim=0)


# ---------------------------------------------------------------------------
# protocol messages
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A versioned bounded-staleness read of one worker's server rows.

    ``alpha_rows`` are the worker's own dual coordinates — conceptually
    worker-owned state (only its commits ever move them); the in-host
    servers keep them centrally so ``weights_from_alpha`` stays one call.

    Structured-Sigma wire format: when the server holds a SigmaView the
    snapshot ships ``sigma_diag`` — the (m_loc,) diagonal entries the local
    solver actually reads — and ``sigma_rows`` is None, shrinking the
    per-snapshot Sigma payload from m_loc * m to m_loc floats.

    Fields are tensors on the server's device when the snapshot is taken
    in-host, numpy arrays once decoded off the wire.
    """

    W_rows: object  # (m_loc, d) weight rows of the worker's tasks
    sigma_rows: object  # (m_loc, m) Sigma rows; None under a structured view
    alpha_rows: object  # (m_loc, n_max) the worker's dual coordinates
    version: int  # server commit count when the snapshot was taken
    sigma_diag: Optional[object] = None  # (m_loc,) view-mode Sigma diagonal


def payload_nbytes(snap: Snapshot, codec=None) -> int:
    """Array bytes one snapshot puts on the wire (bench metric).

    Without a codec this is the raw wire: every populated field (W rows,
    Sigma rows/diag, the worker's alpha rows) at full precision. With a
    codec (name or ``wire.Codec``) it is the steady-state compressed wire:
    the ``(W, Sigma)`` payload encoded, and NO alpha — under a codec the
    dual rows are worker-cached state shipped once at init, not
    per-snapshot traffic.
    """
    if codec is None or getattr(codec, "name", codec) == "none":
        return sum(
            _nbytes(a)
            for a in (snap.W_rows, snap.sigma_rows, snap.alpha_rows, snap.sigma_diag)
            if a is not None
        )
    if not isinstance(codec, Codec):
        codec = get_codec(codec)
    return sum(
        codec.encode(_host(a)).nbytes
        for a in (snap.W_rows, snap.sigma_rows, snap.sigma_diag)
        if a is not None
    )


def decode_snapshot_payload(payload: dict, codec: Codec) -> Snapshot:
    """Worker-side decode of ``_HostServerTransport._encode_snapshot``'s
    wire payload. ``alpha_rows`` is None when the server elided it (the
    worker holds its own cached copy)."""

    def dec(field):
        enc = payload[field]
        return None if enc is None else codec.decode(enc)

    alpha = payload["alpha_rows"]
    return Snapshot(
        W_rows=dec("W_rows"),
        sigma_rows=dec("sigma_rows"),
        alpha_rows=None if alpha is None else np.asarray(alpha),
        version=payload["version"],
        sigma_diag=dec("sigma_diag"),
    )


@dataclasses.dataclass(frozen=True)
class CommitReceipt:
    """Server acknowledgement of one applied contribution.

    ``staleness`` = server commit events between the contribution's
    snapshot and its apply; ``lag`` = rounds it ran ahead of the slowest
    worker at start.  ``tick`` is the transport clock (simulated ticks for
    ``simulated``, wall seconds for the host transports, the round index
    for the synchronous engine).
    """

    worker: int
    round: int  # global round index (p * R + r)
    staleness: int
    lag: int
    tick: float
    version: int  # server commit count after the apply (1-based)
    tau: int  # SSP bound in effect at the apply


def new_event_history() -> Dict[str, list]:
    """The engine history skeleton every transport fills: objective
    samples + per-commit events."""
    return {
        "round": [],  # server commit index of each objective sample
        "tick": [],  # transport clock of each objective sample
        "dual": [],
        "primal": [],
        "gap": [],
        "min_round": [],  # slowest worker's completed rounds at each sample
        "w_worker": [],  # one entry per applied contribution:
        "w_round": [],  # which worker / its round index
        "w_staleness": [],  # commits between its snapshot and its apply
        "w_lag": [],  # rounds ahead of the slowest worker at start
        "w_tick": [],
        "tau_trace": [],  # SSP bound in effect at each commit event
        "gate_refusals": [],  # cumulative gate-refusal episodes at each event
    }


def record_receipt(hist: Dict[str, list], r: CommitReceipt) -> None:
    """THE staleness/lag accounting path: every transport lands here, so
    ``convergence.staleness_summary`` reads one uniform event stream."""
    hist["w_worker"].append(r.worker)
    hist["w_round"].append(r.round)
    hist["w_staleness"].append(r.staleness)
    hist["w_lag"].append(r.lag)
    hist["w_tick"].append(r.tick)


# ---------------------------------------------------------------------------
# tau="auto" controller (shared by every transport)
# ---------------------------------------------------------------------------
def _adapt_tau(
    tau: int,
    gate_blocks: int,
    window_summary: dict,
    tau_max: int,
    staleness_budget: Optional[float] = None,
) -> int:
    """One step of the tau="auto" controller.

    Cost-aware rule: when a ``staleness_budget`` is set and the window's
    observed mean commit staleness exceeds it, narrow — even if the gate
    never refused a start (budget violations outrank throughput).
    Otherwise: widen when the SSP gate actually blocked a worker during the
    window (``gate_blocks`` refusal episodes: a worker entering the blocked
    state counts once, not once per tick it stays blocked); narrow when
    nothing was blocked AND the observed per-commit lag (``max_lag`` over
    the window) stayed strictly under the current bound, i.e. the slack
    went unused.  Clamped to [0, tau_max].
    """
    if (
        staleness_budget is not None
        and window_summary.get("mean_staleness", 0.0) > staleness_budget
    ):
        return max(tau - 1, 0)
    if gate_blocks > 0:
        return min(tau + 1, tau_max)
    if window_summary["max_lag"] < tau:
        return max(tau - 1, 0)
    return tau


def _worker_delays(cfg: DMTRLConfig, n_workers: int) -> tuple:
    delays = (1,) * n_workers if cfg.async_delays is None else cfg.async_delays
    delays = tuple(int(v) for v in delays)
    if len(delays) != n_workers:
        raise ValueError(
            f"async_delays has {len(delays)} entries for {n_workers} workers"
        )
    if min(delays) < 1:
        raise ValueError(f"async_delays must be >= 1, got {delays}")
    return delays


# ---------------------------------------------------------------------------
# host-side per-worker local solve (threaded / multiprocess workers)
# ---------------------------------------------------------------------------
def make_block_solver(cfg: DMTRLConfig, n_max: int, rho: float) -> Callable:
    """The worker half of one round for a host transport: the configured
    solver backend over the worker's task block (the backends are batched
    over tasks), drawing through ``draw_task_uniform`` with pod 0 like the
    single-process driver (=> the same coordinate draws for the same round
    key). Under ``solver="pallas_round"`` that is one launch of the draw
    kernel and one of the round kernel per call.

    solve(x, y, alpha_rows, W_rows, n, sigma_rows, tids, key)
        -> (dalpha_rows, db_rows)

    ``tids`` are the block's global task ids (int64, on the host, like
    ``key``). ``sigma_rows`` dispatches on rank: a 2-D tensor is the
    (m_loc, m) row block of a dense snapshot, a 1-D tensor the (m_loc,)
    ``Snapshot.sigma_diag`` of a structured server — the solver only ever
    reads the diagonal.
    """
    loss = get_loss(cfg.loss)
    backend = get_backend(cfg.solver)
    H = backend.round_local_iters(cfg.local_iters or n_max, cfg.block_size)
    solver = backend.make_from_uniform(loss, rho, cfg.lam, H, block=cfg.block_size)

    def solve(x, y, alpha_rows, W_rows, n, sigma_rows, tids, key):
        u = draw_task_uniform(key, tids, 0, H, x.device)
        if sigma_rows.ndim == 1:
            sigma_ii = sigma_rows
        else:
            local = torch.arange(sigma_rows.shape[0], device=sigma_rows.device)
            sigma_ii = sigma_rows[local, tids.to(sigma_rows.device)]
        dalpha, r = solver(x, y, alpha_rows, W_rows, n, sigma_ii, u)
        # delta_b_i = (eta / n_i) * X_i^T dalpha_i (padded tasks have n=1,
        # x=0 => inert)
        db = cfg.eta * r / torch.clamp(n, min=1)[:, None].to(r.dtype)
        return dalpha, db

    return solve


def _wait(t: Tensor) -> None:
    """Wait for the work queued for ``t`` (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


# ---------------------------------------------------------------------------
# Transport base
# ---------------------------------------------------------------------------
class Transport:
    """Base class: protocol + driver lifecycle every member implements."""

    name: str = "?"
    needs_mesh: bool = False
    n_pods: int = 1  # rho n_blocks_scale (pod sharding: mesh engines only)

    def __init__(self):
        self._model_subscribers: List[Callable] = []
        self._model_version = 0
        # worker whose gate/snapshot/commit triggered the install in
        # flight (None for driver-initiated installs) — log context only
        self._install_worker: Optional[int] = None

    # -- model snapshot subscription (serving hot-swap hook) ----------------
    def subscribe(self, callback: Callable) -> Callable:
        """Register ``callback(W, sigma, version)`` to fire after every
        Sigma install — the point where a new servable ``(W, Sigma)``
        exists. W and a dense Sigma arrive as tensors on the run's device
        at the RAW problem size (padding stripped); versions strictly
        increase across the run. The serving scheduler's
        ``publish_weights`` has exactly this signature, so

            transport.subscribe(scheduler.publish_weights)

        hot-swaps live training commits into a serving queue, and a
        ``serve.fleet.FleetRouter`` is a drop-in second subscriber tier.
        Callbacks run on the installing thread under the server lock: keep
        them quick and NEVER call back into the transport. A subscriber
        that keeps W keeps a copy (``serve.scheduler.owned``).
        """
        self._model_subscribers.append(callback)
        return callback

    def unsubscribe(self, callback: Callable) -> bool:
        """Deregister a ``subscribe``d callback (identity match, first
        occurrence). Returns True when removed, False when the callback
        was not registered."""
        try:
            self._model_subscribers.remove(callback)
            return True
        except ValueError:
            return False

    def _notify_model(self, W: Tensor, sigma) -> None:
        self._model_version += 1
        if not self._model_subscribers:
            return
        # per-subscriber isolation: one raising callback (a broken serving
        # tier) must never unwind the Sigma-install path or starve the
        # other subscribers — log it, drop it, keep installing
        failed = []
        for cb in list(self._model_subscribers):
            try:
                cb(W, sigma, self._model_version)
            except Exception:
                logger.exception(
                    "transport %r: model subscriber %r raised at snapshot "
                    "version %d (install triggered by worker %s); dropping "
                    "it (installs continue)",
                    self.name,
                    cb,
                    self._model_version,
                    "driver" if self._install_worker is None else self._install_worker,
                )
                failed.append(cb)
        for cb in failed:
            self.unsubscribe(cb)

    # -- driver lifecycle ---------------------------------------------------
    def setup(self, cfg, raw, *, mesh, axes, reg, init, track, device="cuda") -> None:
        raise NotImplementedError

    def run_w_step(self, p: int, rho: float, outer_key: Tensor) -> None:
        """Drive all workers through cfg.rounds rounds of the protocol,
        then apply any still-pending Sigma install at the barrier."""
        raise NotImplementedError

    def w_true(self) -> Tensor:
        """Current W rows of the REAL tasks (for the Omega-step)."""
        raise NotImplementedError

    def rho_sigma(self):
        """Sigma the next W-step's rho bound should be computed from."""
        raise NotImplementedError

    def pad_sigma(self, sigma_t, omega_t) -> Tuple[object, object]:
        raise NotImplementedError

    def next_sigma(self, reg) -> Tuple[object, object]:
        """The Omega-step on the current W: the padded (Sigma, Omega) to
        install."""
        return self.pad_sigma(*reg.step(self.w_true(), self.cfg.omega_jitter))

    def rho_value(self, cfg, sigma, reg) -> float:
        """The rho bound of the next W-step for ``sigma``."""
        return _rho_value(cfg, sigma, n_blocks_scale=float(self.n_pods), reg=reg)

    def result(self):
        """(W, sigma, state, hist) at the raw problem size."""
        raise NotImplementedError

    def close(self) -> None:  # idempotent; called by the driver's finally
        pass

    # -- worker-facing protocol --------------------------------------------
    def gate(self, worker: int, rnd: int) -> bool:
        raise NotImplementedError

    def snapshot(self, worker: int) -> Snapshot:
        raise NotImplementedError

    def commit(self, worker: int, rnd: int, delta) -> CommitReceipt:
        raise NotImplementedError

    def install_sigma(self, sigma, omega, *, defer: bool) -> None:
        raise NotImplementedError

    # -- introspection ------------------------------------------------------
    def clock(self) -> float:
        """Transport time: simulated ticks / wall seconds since setup."""
        raise NotImplementedError

    def staleness(self) -> Dict[str, object]:
        """``convergence.staleness_summary`` over the commits so far."""
        return conv_mod.staleness_summary(
            {k: np.asarray(v) for k, v in self.hist.items()}
        )

    # -- shared per-commit-event bookkeeping --------------------------------
    def _after_commit_event(self, tick, alpha, sigma) -> None:
        """tau trace + tau="auto" adapt window + track_every objective
        sampling after ONE server commit event.  Shared by every member so
        the adaptive controller and the recorded histories can never drift
        between transports. Callers hold the server lock."""
        cfg, hist = self.cfg, self.hist
        hist["tau_trace"].append(self.tau)
        hist["gate_refusals"].append(self.gate_refusals_total)
        if self.tau_auto and self.commits_total % self.adapt_window == 0:
            win = {
                k: np.asarray(hist[k][self.win_start :])
                for k in ("w_staleness", "w_lag", "w_worker")
            }
            self.tau = _adapt_tau(
                self.tau,
                self.gate_blocks,
                conv_mod.staleness_summary(win),
                cfg.tau_max,
                cfg.staleness_budget,
            )
            self.gate_blocks = 0
            self.refused = set()  # a still-blocked worker re-counts
            self.win_start = len(hist["w_worker"])
        done = min(self.completed) >= self.R
        if self.track and (self.commits_total % cfg.track_every == 0 or done):
            dd, pp = self._objectives(alpha, sigma)
            hist["round"].append(self.commits_total)
            hist["tick"].append(tick)
            hist["dual"].append(float(dd))
            hist["primal"].append(float(pp))
            hist["gap"].append(float(pp - dd))
            hist["min_round"].append(self.p * self.R + min(self.completed))


# ---------------------------------------------------------------------------
# fused SPMD tick of the simulated transport
# ---------------------------------------------------------------------------
def make_async_tick(cfg: DMTRLConfig, mesh, axes: MeshAxes, m: int, n_max: int, d: int,
                    rho: float):
    """One tick of the simulated transport on this rank's blocks:

        tick(x, y, n, alpha, W, sigma_rows, W_snap, sigma_snap, key, active)
            -> (alpha, W)

    ``W_snap``/``sigma_snap`` are this rank's worker's bounded-staleness
    snapshot rows, ``key`` the key of the round that worker is solving and
    ``active`` whether its result commits this tick. The worker solves
    against its snapshot; the server reduce uses the live Sigma rows and
    only the active contributions. An inactive worker's solve is skipped:
    its contribution is zero either way."""
    local_solve = make_local_solve(cfg, mesh, axes, m, n_max, d, rho)

    def tick(x, y, n, alpha, W, sigma_rows, W_snap, sigma_snap, key, active):
        if active:
            dalpha, db = local_solve(x, y, n, alpha, W_snap, sigma_snap, key)
        else:
            dalpha, db = torch.zeros_like(alpha), torch.zeros_like(W)
        dW = server_reduce(cfg, mesh, axes, sigma_rows, db)
        return alpha + cfg.eta * dalpha, W + dW

    return tick


# ---------------------------------------------------------------------------
# simulated — deterministic per-worker clocks, fused SPMD commits
# ---------------------------------------------------------------------------
class SimulatedTransport(Transport):
    """The deterministic clock simulation over a mesh.

    Virtual workers (the ``data`` axis) advance on a simulated clock (worker
    g takes ``async_delays[g]`` ticks per local solve); every commit event
    runs one masked SPMD tick over the whole mesh (``make_async_tick``), so
    runs repeat exactly: the integer event histories of
    ``tests/golden/async_histories.json`` are reproduced, and at tau = 0
    the iterates are ``fit_distributed``'s. Every rank runs the same event
    loop and keeps its own worker's snapshot rows; the Omega-step, rho and
    the objectives are computed on the root and broadcast
    (``distributed.MeshRun``). Structured Sigma views are made dense here
    (the tick takes dense Sigma rows); the host transports keep the
    factors.
    """

    name = "simulated"
    needs_mesh = True

    def setup(self, cfg, raw, *, mesh, axes, reg, init, track, device="cuda"):
        if mesh is None:
            raise ValueError("the simulated transport needs a mesh")
        axes = axes or MeshAxes()
        codec = getattr(cfg, "codec", "none")
        if codec != "none":
            raise ValueError(
                "transport='simulated' is the bit-parity anchor and has no "
                f"wire; codec={codec!r} needs a host transport "
                "('threaded' / 'multiprocess' / 'gossip')"
            )
        topology = getattr(cfg, "topology", "complete")
        if not (isinstance(topology, str) and topology == "complete"):
            raise ValueError(
                "topology= is a gossip-transport option; transport="
                "'simulated' has no neighbor graph (use transport='gossip')"
            )
        G = _axis_size(mesh, axes.data)
        if cfg.n_workers is not None and cfg.n_workers != G:
            raise ValueError(
                f"transport='simulated' derives its workers from the mesh "
                f"data axis (= {G}); n_workers={cfg.n_workers} conflicts"
            )
        self.cfg, self.mesh, self.axes = cfg, mesh, axes
        self.reg, self.track = reg, track
        self.run = run = MeshRun(cfg, raw, mesh, axes, reg, init)
        self.raw, self.data, self.m, self.d = run.raw, run.data, run.m, run.d
        if isinstance(run.sigma, SigmaView) or isinstance(run.omega, SigmaView):
            run.set_sigma(*on_root(lambda: _densify_pair(run.sigma, run.omega), mesh))
            run.refresh_W()
        self.G = G
        self.worker = mesh.coord(axes.data)  # the worker whose rows this rank holds
        self.m_loc = self.m // G
        self.delays = _worker_delays(cfg, G)
        self.n_pods = run.n_pods
        self.R = cfg.rounds
        self.hist = new_event_history()
        self._objectives = lambda alpha, sigma: run.objectives()
        # snapshots start in sync with the live state
        self.W_snap = run.state.W
        self.sigma_snap = run.state.sigma
        self.commits_total = 0
        self._clock = 0  # global simulated time, accumulated across W-steps
        self.pending = None  # (sigma, omega) awaiting overlap installation
        # tau="auto": start bulk-synchronous, adapt once per G-commit window
        self.tau_auto = cfg.tau == "auto"
        self.tau = 0 if self.tau_auto else cfg.tau
        self.adapt_window = G
        self.gate_blocks = 0  # refusal EPISODES this window
        self.gate_refusals_total = 0
        self.refused: set = set()
        self.win_start = 0  # w_* index where the adapt window began
        # per-worker protocol bookkeeping (reset each W-step)
        self.completed = [0] * G
        self.cur_round = [0] * G
        self.snap_commit = [0] * G
        self.snap_lag = [0] * G
        self.commits_outer = 0
        self.p = 0
        # no wire (in-mesh SPMD), but the unified schema still applies
        self.wire_stats = new_wire_stats(topology="complete")

    # -- protocol -----------------------------------------------------------
    def gate(self, worker, rnd):
        """SSP admission (non-blocking): the deterministic event loop polls
        the decision instead of parking a thread on it."""
        return rnd <= min(self.completed) + self.tau

    def _rows(self, worker):
        return slice(worker * self.m_loc, (worker + 1) * self.m_loc)

    def snapshot(self, worker):
        """The worker's rows (W, Sigma, alpha) on every rank (a collective:
        every rank calls it)."""
        rows = self._rows(worker)
        self.snap_commit[worker] = self.commits_total
        self.snap_lag[worker] = self.completed[worker] - min(self.completed)
        return Snapshot(
            W_rows=self.run.gather_W()[rows],
            sigma_rows=self.run.sigma[rows],
            alpha_rows=self.run.gather_alpha()[rows],
            version=self.commits_total,
        )

    def commit(self, worker, rnd, delta):
        """Apply ONE worker's (dalpha_rows, db_rows) immediately; every rank
        passes the worker's whole rows (m_loc, n_max) and (m_loc, d).

        The deterministic event loop in ``run_w_step`` does not use this —
        it fuses all same-tick arrivals into one masked SPMD reduce; this
        method makes the protocol complete so a generic protocol loop can run
        the simulated member one worker at a time."""
        self._maybe_install(worker)
        dalpha, db = delta
        run, cfg = self.run, self.cfg
        st = run.state
        alpha = st.alpha
        if worker == self.worker:
            alpha = alpha + cfg.eta * dalpha[:, run.cols]
        W = st.W + (run.sigma[self._rows(worker), run.rows].T @ db[:, run.feats]) / cfg.lam
        run.state = dataclasses.replace(st, alpha=alpha, W=W)
        self.commits_total += 1
        self.commits_outer += 1
        self.completed[worker] += 1
        receipt = CommitReceipt(
            worker=worker,
            round=self.p * self.R + rnd,
            staleness=self.commits_total - 1 - self.snap_commit[worker],
            lag=self.snap_lag[worker],
            tick=self._clock + self.commits_outer,
            version=self.commits_total,
            tau=self.tau,
        )
        record_receipt(self.hist, receipt)
        self._after_commit_event(receipt.tick, None, None)
        return receipt

    def install_sigma(self, sigma, omega, *, defer):
        if defer:
            self.pending = (sigma, omega)
        else:
            self._install(sigma, omega)

    def _install(self, sig, om):
        with span("install_sigma", cat="transport", transport=self.name):
            self.run.set_sigma(sig, om)
            self.run.refresh_W()
            W, sigma = self.run.result_W_sigma()
            self._notify_model(W, sigma)

    def _maybe_install(self, worker=None):
        if self.pending is not None and self.commits_outer >= self.cfg.omega_delay:
            self._install_worker = worker
            try:
                self._install(*self.pending)
            finally:
                self._install_worker = None
            self.pending = None

    # -- lifecycle ----------------------------------------------------------
    def w_true(self):
        return self.run.gather_W()[: self.raw.m]

    def rho_sigma(self):
        return self.run.sigma

    def rho_value(self, cfg, sigma, reg) -> float:
        return on_root(lambda: super(SimulatedTransport, self).rho_value(cfg, sigma, reg),
                       self.mesh, like=0.0)

    def pad_sigma(self, sigma_t, omega_t):
        return pad_sigma_any(sigma_t, omega_t, self.m, self.raw.m, self.cfg.omega_jitter)

    def next_sigma(self, reg):
        return self.run.omega_step(densify=True)

    def clock(self):
        return self._clock

    def run_w_step(self, p, rho, outer_key):
        cfg, G, R, run = self.cfg, self.G, self.R, self.run
        self.p = p
        tick_fn = make_async_tick(cfg, self.mesh, self.axes, self.m, run.n_max, self.d, rho)
        # the key schedule of fit_distributed: the same coordinate draws
        round_keys = prng.split(outer_key, R)  # (R, 2)

        self.completed = [0] * G
        self.cur_round = [0] * G
        busy = [False] * G
        finish_at = [0] * G
        tick = 0
        self.commits_outer = 0
        hist = self.hist
        me = self.worker

        while min(self.completed) < R:
            # --- overlapped Omega-step installation --------------------
            self._maybe_install()
            # --- starts: idle workers gated by the SSP staleness bound --
            floor = min(self.completed)
            idle = [g for g in range(G) if not busy[g] and self.completed[g] < R]
            newly = [g for g in idle if self.gate(g, self.completed[g])]
            blocked = {g for g in idle if not self.gate(g, self.completed[g])}
            fresh_blocks = len(blocked - self.refused)
            self.gate_blocks += fresh_blocks
            self.gate_refusals_total += fresh_blocks
            self.refused = blocked
            if me in newly:  # this rank's worker (re)starts: fresh snapshot
                self.W_snap = run.state.W
                self.sigma_snap = run.state.sigma
            for g in newly:
                busy[g] = True
                self.cur_round[g] = self.completed[g]
                finish_at[g] = tick + self.delays[g]
                self.snap_commit[g] = self.commits_total
                self.snap_lag[g] = self.completed[g] - floor
            # --- advance the clock to the next finish event ------------
            tick = min(finish_at[g] for g in range(G) if busy[g])
            active = [g for g in range(G) if busy[g] and finish_at[g] == tick]
            key = round_keys[min(max(self.cur_round[me], 0), R - 1)]
            st = run.state
            alpha, W = tick_fn(
                run.data.x, run.data.y, run.data.n, st.alpha, st.W, st.sigma,
                self.W_snap, self.sigma_snap, key, me in active,
            )
            run.state = dataclasses.replace(st, alpha=alpha, W=W)
            self.commits_total += 1
            self.commits_outer += 1
            for g in active:
                busy[g] = False
                record_receipt(
                    hist,
                    CommitReceipt(
                        worker=g,
                        round=p * R + self.cur_round[g],
                        staleness=self.commits_total - 1 - self.snap_commit[g],
                        lag=self.snap_lag[g],
                        tick=self._clock + tick,
                        version=self.commits_total,
                        tau=self.tau,
                    ),
                )
                self.completed[g] += 1
            self._after_commit_event(self._clock + tick, None, None)

        self._clock += tick
        # --- W-step boundary: a pending Sigma must never be dropped ----
        if self.pending is not None:
            self._install(*self.pending)
            self.pending = None

    def result(self):
        """(W, sigma, state, hist): W and Sigma at the raw size and
        ``state`` the whole padded state, on every rank."""
        hist_np = {k: np.asarray(v) for k, v in self.hist.items()}
        W, sigma = self.run.result_W_sigma()
        return W, sigma, self.run.gathered_state(), hist_np


# ---------------------------------------------------------------------------
# host parameter server — shared by the threaded and multiprocess members
# ---------------------------------------------------------------------------
class _HostServerTransport(Transport):
    """Lock-protected versioned parameter-server state.

    The server owns (alpha, W, sigma, omega) on the run's device plus the
    SSP bookkeeping behind one condition variable; ``gate`` BLOCKS the
    calling worker (thread or connection handler) until admission,
    ``snapshot``/``commit`` are single critical sections.  Subclasses differ
    only in who the workers are (threads vs socket-connected processes).

    Snapshot versioning: workers read the newest ROUND-BOUNDARY version of
    ``(W, sigma)`` — the state frozen when ``min(completed)`` last advanced
    (or the W-step began) — not the live tensors, so a worker admitted late
    into a round sees the same read set as one admitted first.  At tau=0
    this is exactly the bulk-synchronous read set, which makes the final
    iterates order-independent up to float association (the parity anchor
    against the ``reference`` engine).  A worker's own dual rows
    (``alpha_rows``) are always current: only its own commits move them.
    Its W rows are the boundary's plus its own commits since the freeze
    (read-your-writes, as stale synchronous parallelism defines its
    reads). The JAX package's host servers serve the boundary's rows
    alone: at tau > 0 a worker running ahead then solves against a W
    without its own last commit while its alpha has it, and repeats that
    step (tests/probe_read_your_writes.py compares the final gaps). At tau = 0 a
    worker starts a round only after the boundary holds its commits, so
    both read the same. Receipt staleness is stamped from the commit count
    at which the served boundary was frozen — the true age of the data
    read.

    The boundary is a pair of references to the tensors current when it was
    frozen; it stays valid because every update below replaces
    ``self.alpha`` / ``self.W`` with a new tensor instead of writing the
    old one.
    """

    needs_mesh = False

    def setup(self, cfg, raw, *, mesh, axes, reg, init, track, device="cuda"):
        axes = axes or MeshAxes()
        if mesh is not None and (
            _axis_size(mesh, axes.model) > 1 or _axis_size(mesh, axes.pod) > 1
        ):
            raise ValueError(
                f"transport={self.name!r} shards tasks over workers only; "
                "model/pod mesh axes need the mesh engines"
            )
        G = cfg.n_workers
        if G is None:
            G = _axis_size(mesh, axes.data) if mesh is not None else 1
        self.device = resolve_device(device)
        raw = raw.to(self.device)
        self.cfg, self.raw, self.reg, self.track = cfg, raw, reg, track
        self.G = G
        self.m = pad_to_multiple(raw.m, G)
        self.m_loc = self.m // G
        self.data = raw.pad_tasks(self.m)
        self.delays = _worker_delays(cfg, G)
        self.pace = 0.0 if cfg.async_delays is None else PACE_SECONDS
        self.R = cfg.rounds
        data, dtype, dev = self.data, self.data.x.dtype, self.device
        loss = get_loss(cfg.loss)

        def objectives(alpha, sigma):
            dd = dual_mod.dual_objective(data, alpha, sigma, cfg.lam, loss)
            pp = dual_mod.primal_objective_from_alpha(data, alpha, sigma, cfg.lam, loss)
            return dd, pp

        def w_from_alpha(alpha, sigma):
            return dual_mod.weights_from_alpha(data, alpha, sigma, cfg.lam)

        self._objectives = objectives
        self._w_from_alpha = w_from_alpha

        def tensor(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        self.alpha = torch.zeros((self.m, data.n_max), dtype=dtype, device=dev)
        self.W = torch.zeros((self.m, data.d), dtype=dtype, device=dev)
        self.sigma, self.omega = omega_mod.init_sigma(self.m, dtype, dev)
        # warm start / custom-init regularizer; structured members install
        # their SigmaView init and the server keeps the factors end to end
        sigma_t = omega_t = None
        if init is not None:
            sigma_t = init.sigma if isinstance(init.sigma, SigmaView) else tensor(init.sigma)
            omega_t = init.omega
            if omega_t is not None and not isinstance(omega_t, SigmaView):
                omega_t = tensor(omega_t)
        elif reg.custom_init or reg.structured:
            sigma_t, omega_t = reg.init(raw.m, dtype, dev)
        if sigma_t is not None:
            self.sigma, self.omega = pad_sigma_any(
                sigma_t, omega_t, self.m, raw.m, cfg.omega_jitter
            )
        if init is not None:
            alpha0 = torch.zeros((self.m, data.n_max), dtype=dtype, device=dev)
            alpha0[: raw.m, : raw.n_max] = tensor(init.alpha)
            self.alpha = alpha0
            self.W = w_from_alpha(self.alpha, self.sigma)

        self.lock = threading.RLock()
        self.cond = threading.Condition(self.lock)
        self.completed = [0] * G
        self.commits_total = 0
        self.commits_outer = 0
        self.pending = None
        self.tau_auto = cfg.tau == "auto"
        self.tau = 0 if self.tau_auto else cfg.tau
        self.adapt_window = G
        self.gate_blocks = 0
        self.gate_refusals_total = 0
        self.refused: set = set()
        self.win_start = 0
        self._snap_version = [0] * G
        self._snap_lag = [0] * G
        self._freeze_boundary()
        self.hist = new_event_history()
        self.abort: Optional[BaseException] = None
        self._shutdown = False  # set by close(); unparks gate waiters
        self._t0 = time.monotonic()
        self.p = 0
        # --- wire codec (core/wire.py) ---------------------------------
        topology = getattr(cfg, "topology", "complete")
        if self.name in ("threaded", "multiprocess") and not (
            isinstance(topology, str) and topology == "complete"
        ):
            raise ValueError(
                f"topology= is a gossip-transport option; transport="
                f"{self.name!r} is a star topology (use transport='gossip')"
            )
        self.codec: Codec = get_codec(getattr(cfg, "codec", "none"))
        self._commit_ef = ErrorFeedback(self.codec)
        self._alpha_cache: Dict[int, np.ndarray] = {}
        self.wire_stats = new_wire_stats(codec=self.codec.name)

    # -- protocol (all under the server condition variable) -----------------
    def _rows(self, worker):
        return slice(worker * self.m_loc, (worker + 1) * self.m_loc)

    def _check_abort(self):
        if self.abort is not None:
            raise RuntimeError(
                f"transport {self.name!r} aborted: {self.abort!r}"
            ) from self.abort

    def gate(self, worker, rnd):
        """Block until the SSP gate admits ``worker`` to start ``rnd``."""
        with span("gate", cat="transport", worker=worker, round=rnd), self.cond:
            while True:
                self._check_abort()
                if self._shutdown:
                    raise RuntimeError(
                        f"transport {self.name!r} shut down while worker "
                        f"{worker} was waiting at the gate"
                    )
                self._maybe_install(worker)
                if rnd <= min(self.completed) + self.tau:
                    self.refused.discard(worker)
                    return True
                # refusal EPISODES: count on entering the blocked state, and
                # again after an adapt-window rollover clears ``refused``
                # while this worker still waits
                if worker not in self.refused:
                    self.refused.add(worker)
                    self.gate_blocks += 1
                    self.gate_refusals_total += 1
                self.cond.wait(timeout=0.05)

    def _boundary_snapshot(self, worker, W_rows, sigma_b) -> Snapshot:
        """The snapshot of ``worker``: its W rows ``W_rows``, its rows of the
        boundary's ``sigma_b``, its current alpha rows, and the bookkeeping
        its receipt reads. Caller holds the lock."""
        rows = self._rows(worker)
        # staleness is the age of the DATA served (the boundary freeze),
        # not of the snapshot call itself
        self._snap_version[worker] = self._boundary_version
        self._snap_lag[worker] = self.completed[worker] - min(self.completed)
        if isinstance(sigma_b, SigmaView):
            # structured server: ship only the diagonal the local solver
            # reads — m_loc floats instead of m_loc * m
            return Snapshot(
                W_rows=W_rows,
                sigma_rows=None,
                alpha_rows=self.alpha[rows],
                version=self._boundary_version,
                sigma_diag=sigma_b.diag()[rows],
            )
        return Snapshot(
            W_rows=W_rows,
            sigma_rows=sigma_b[rows],
            alpha_rows=self.alpha[rows],
            version=self._boundary_version,
        )

    def snapshot(self, worker):
        with span("snapshot", cat="transport", worker=worker), self.cond:
            self._check_abort()
            self._maybe_install(worker)
            W_b, sigma_b = self._boundary
            W_rows = W_b[self._rows(worker)]
            if self._own[worker] is not None:  # read-your-writes
                W_rows = W_rows + self._own[worker]
            return self._boundary_snapshot(worker, W_rows, sigma_b)

    def _reduce(self, rows: slice, db: Tensor) -> Tensor:
        """The Sigma-coupled server reduce of ONE worker's delta_b rows:
        Sigma[:, rows] @ db / lam (sigma is symmetric)."""
        if isinstance(self.sigma, SigmaView):
            return self.sigma.col_block_matvec(rows.start, db) / self.cfg.lam
        return (self.sigma[rows].T @ db) / self.cfg.lam

    def _apply(self, worker: int, upd: Tensor) -> None:
        """Apply one worker's reduced update to the served W."""
        self.W = self.W + upd

    def _freeze_boundary(self) -> None:
        """Freeze the (W, sigma) that snapshots serve; the workers' own
        writes since the last freeze are in it."""
        self._boundary = (self.W, self.sigma)
        self._boundary_version = self.commits_total
        self._own = [None] * self.G

    def _at_boundary(self, tick: float) -> None:
        """A round boundary: freeze the snapshot version later starters of
        the next round will read (see class docstring)."""
        self._freeze_boundary()

    def commit(self, worker, rnd, delta):
        dalpha, db = delta
        with span("commit", cat="transport", worker=worker, round=rnd), self.cond:
            self._check_abort()
            self._maybe_install(worker)
            rows = self._rows(worker)
            self.alpha = _add_rows(self.alpha, rows, self.cfg.eta * dalpha)
            upd = self._reduce(rows, db)
            self._apply(worker, upd)
            own = self._own[worker]
            self._own[worker] = upd[rows] if own is None else own + upd[rows]
            stal = self.commits_total - self._snap_version[worker]
            self.commits_total += 1
            self.commits_outer += 1
            floor_before = min(self.completed)
            self.completed[worker] += 1
            tick = time.monotonic() - self._t0
            if min(self.completed) > floor_before:
                self._at_boundary(tick)
            receipt = CommitReceipt(
                worker=worker,
                round=self.p * self.R + rnd,
                staleness=stal,
                lag=self._snap_lag[worker],
                tick=tick,
                version=self.commits_total,
                tau=self.tau,
            )
            record_receipt(self.hist, receipt)
            self._after_commit_event(tick, self.alpha, self.sigma)
            self.cond.notify_all()
            return receipt

    def install_sigma(self, sigma, omega, *, defer):
        with self.cond:
            if defer:
                self.pending = (sigma, omega)
            else:
                self._install(sigma, omega)

    def _install(self, sig, om):
        with span("install_sigma", cat="transport", transport=self.name):
            self.sigma, self.omega = sig, om
            self.W = self._w_from_alpha(self.alpha, self.sigma)
            # W was just recomputed from exact (full-precision) alpha, so any
            # pending quantization residual no longer refers to live state
            self._commit_ef.reset()
            # the install must reach the NEXT snapshot, not wait for the
            # next floor advance: refresh the served boundary
            self._freeze_boundary()
            if isinstance(self.sigma, SigmaView):
                sigma_raw = self.sigma.unpad(self.raw.m)
            else:
                sigma_raw = self.sigma[: self.raw.m, : self.raw.m]
            self._notify_model(self.W[: self.raw.m, : self.raw.d], sigma_raw)

    def _maybe_install(self, worker=None):
        if self.pending is not None and self.commits_outer >= self.cfg.omega_delay:
            self._install_worker = worker
            try:
                self._install(*self.pending)
            finally:
                self._install_worker = None
            self.pending = None

    def _fail(self, exc: BaseException):
        with self.cond:
            if self.abort is None:
                self.abort = exc
            self.cond.notify_all()

    # -- wire codec (snapshot/commit serialization) -------------------------
    def _encode_snapshot(self, worker: int, have_alpha: bool) -> dict:
        """Take one snapshot and encode it for the wire (host arrays).

        ``(W, Sigma)`` fields go through the codec; the worker's alpha
        rows are its own dual state — under a lossy codec they ship
        exactly ONCE (``have_alpha=False``) and then live worker-side
        (the worker replays its own ``eta * dalpha`` commits), under the
        ``none`` codec they ship raw every time. Updates ``wire_stats``
        under the server lock.
        """
        snap = self.snapshot(worker)
        with span("snapshot_encode", cat="transport", worker=worker):
            raw = payload_nbytes(snap)
            payload: dict = {"version": snap.version}
            nb = 0
            for field in ("W_rows", "sigma_rows", "sigma_diag"):
                a = getattr(snap, field)
                if a is None:
                    payload[field] = None
                    continue
                enc = self.codec.encode(_host(a))
                payload[field] = enc
                nb += enc.nbytes
            if self.codec.name == "none" or not have_alpha:
                alpha = _host(snap.alpha_rows)
                payload["alpha_rows"] = alpha
                nb += int(alpha.nbytes)
            else:
                payload["alpha_rows"] = None
            with self.lock:
                self.wire_stats["n_snapshots"] += 1
                self.wire_stats["raw_snapshot_bytes"] += raw
                self.wire_stats["snapshot_bytes"] += nb
            return payload

    def wire_snapshot(self, worker: int) -> Snapshot:
        """Snapshot as seen through the codec round-trip (the in-host
        mirror of what a remote worker would decode off the socket):
        numpy fields."""
        have = self.codec.name != "none" and worker in self._alpha_cache
        payload = self._encode_snapshot(worker, have_alpha=have)
        with span("snapshot_decode", cat="transport", worker=worker):
            snap = decode_snapshot_payload(payload, self.codec)
        if snap.alpha_rows is None:
            snap = dataclasses.replace(snap, alpha_rows=self._alpha_cache[worker])
        elif self.codec.name != "none":
            self._alpha_cache[worker] = np.asarray(snap.alpha_rows)
        return snap

    def wire_commit(self, worker: int, rnd: int, delta) -> CommitReceipt:
        """Commit through the codec: delta_w (``db``) is encoded with
        per-worker error feedback and the server applies the DECODED
        delta — exactly what a remote peer would receive. ``dalpha`` is
        the worker's own dual state (applied as is for the in-host
        server's central bookkeeping; not part of the delta_w wire
        metric). Under the ``none`` codec nothing leaves the device."""
        dalpha, db = delta
        if self.codec.name == "none":
            raw = _nbytes(db)
            with self.lock:
                self.wire_stats["n_commits"] += 1
                self.wire_stats["raw_commit_bytes"] += raw
                self.wire_stats["commit_bytes"] += raw
            return self.commit(worker, rnd, (dalpha, db))
        with span("commit_encode", cat="transport", worker=worker):
            db_host = _host(db)
            enc = self._commit_ef.encode(("db", worker), db_host)
            db_dec = torch.as_tensor(self.codec.decode(enc), device=self.device)
        if worker in self._alpha_cache:
            # keep the worker-side alpha mirror exact: the same f32
            # arithmetic as the server's alpha rows + eta * dalpha
            self._alpha_cache[worker] = np.asarray(
                self._alpha_cache[worker] + self.cfg.eta * _host(dalpha)
            )
        with self.lock:
            self.wire_stats["n_commits"] += 1
            self.wire_stats["raw_commit_bytes"] += int(db_host.nbytes)
            self.wire_stats["commit_bytes"] += enc.nbytes
        return self.commit(worker, rnd, (dalpha, db_dec))

    # -- driver lifecycle ---------------------------------------------------
    def _begin_w_step(self, p):
        with self.cond:
            self._check_abort()
            self.p = p
            self.completed = [0] * self.G
            self.commits_outer = 0
            self._freeze_boundary()

    def _end_w_step(self):
        with self.cond:
            self._check_abort()
            if self.pending is not None:  # barrier: never drop a Sigma
                self._install(*self.pending)
                self.pending = None

    def w_true(self):
        with self.lock:
            return self.W[: self.raw.m]

    def rho_sigma(self):
        with self.lock:
            return self.sigma

    def pad_sigma(self, sigma_t, omega_t):
        return pad_sigma_any(sigma_t, omega_t, self.m, self.raw.m, self.cfg.omega_jitter)

    def clock(self):
        return time.monotonic() - self._t0

    def result(self):
        """(W, sigma, state, hist): W (raw m, d) and a dense Sigma (or a
        huge SigmaView) on the run's device; ``state`` holds the padded
        server tensors."""
        with self.lock:
            hist_np = {k: np.asarray(v) for k, v in self.hist.items()}
            W = self.W[: self.raw.m, : self.raw.d]
            if isinstance(self.sigma, SigmaView):
                sigma = maybe_dense(self.sigma.unpad(self.raw.m))
            else:
                sigma = self.sigma[: self.raw.m, : self.raw.m]
            state = DistributedState(
                alpha=self.alpha, W=self.W, sigma=self.sigma, omega=self.omega
            )
        return W, sigma, state, hist_np


class ThreadedTransport(_HostServerTransport):
    """Real in-host parameter server: G worker threads against the locked
    server state.  Arrival order is genuinely nondeterministic (OS
    scheduling), the SSP gate still bounds lag by tau.  ``async_delays``
    pace the workers (``PACE_SECONDS`` per tick) so straggler schedules
    remain expressible under real clocks. On the card every worker
    launches on the same (default) stream, so their solves queue one
    behind another on the device."""

    name = "threaded"

    def run_w_step(self, p, rho, outer_key):
        self._begin_w_step(p)
        round_keys = prng.split(outer_key, self.R)
        solve = make_block_solver(self.cfg, self.data.n_max, rho)
        dev = self.device
        blocks = [
            (
                self.data.x[self._rows(g)],
                self.data.y[self._rows(g)],
                self.data.n[self._rows(g)],
                torch.arange(g * self.m_loc, (g + 1) * self.m_loc),
            )
            for g in range(self.G)
        ]

        def worker(g):
            try:
                x, y, n, tids = blocks[g]
                for r in range(self.R):
                    with span("round", cat="transport", worker=g, round=r):
                        self.gate(g, r)
                        snap = self.wire_snapshot(g)
                        sig = snap.sigma_rows if snap.sigma_rows is not None else snap.sigma_diag
                        with span("solve", cat="transport", worker=g, round=r):
                            dalpha, db = solve(
                                x, y, torch.as_tensor(snap.alpha_rows, device=dev),
                                torch.as_tensor(snap.W_rows, device=dev), n,
                                torch.as_tensor(sig, device=dev), tids, round_keys[r],
                            )
                            _wait(dalpha)
                        if self.pace:
                            time.sleep(self.pace * self.delays[g])
                        self.wire_commit(g, r, (dalpha, db))
            except Exception as e:  # propagate into the driver
                self._fail(e)

        threads = [
            threading.Thread(target=worker, args=(g,), name=f"dmtrl-worker-{g}", daemon=True)
            for g in range(self.G)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._end_w_step()


# ---------------------------------------------------------------------------
# multiprocess — socket/pickle parameter-server shim, per-worker processes
# ---------------------------------------------------------------------------
def _send_msg(sock: socket.socket, obj) -> None:
    """One frame: version byte + 8-byte length + pickle payload. The
    leading ``WIRE_VERSION`` byte makes protocol/codec skew between the
    two ends fail as a ``TransportProtocolError`` at the frame boundary
    instead of a pickle garbage crash mid-payload (wire.py)."""
    buf = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("!BQ", WIRE_VERSION, len(buf)) + buf)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("transport peer closed the connection")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    version, n = struct.unpack("!BQ", _recv_exact(sock, 9))
    check_wire_version(version)
    return pickle.loads(_recv_exact(sock, n))


class MultiprocessTransport(_HostServerTransport):
    """The threaded server state machine driven over a loopback socket by
    per-worker *processes* (length-prefixed pickle frames, one handler
    thread per connection) — the cross-host RPC shape with the host
    boundary faked by localhost.  Trusted-local shim only: pickle framing
    is not an authentication boundary.

    Each worker is a fresh interpreter (``subprocess``, never ``fork``)
    with this package's source root on its ``PYTHONPATH``; the init
    message gives it its task block, the run's device and the kernels'
    build directory. On the card the parent builds the kernels of the
    configured solver before it spawns, so the workers only load them.
    The ``start_workers`` span covers the spawn until every worker has its
    block on its device and asks for work; ``stop_workers`` their exit."""

    name = "multiprocess"

    def setup(self, cfg, raw, *, mesh, axes, reg, init, track, device="cuda"):
        super().setup(
            cfg, raw, mesh=mesh, axes=axes, reg=reg, init=init, track=track, device=device
        )
        self._listener: Optional[socket.socket] = None
        self._procs: List[subprocess.Popen] = []
        self._conns: Dict[int, socket.socket] = {}
        self._handlers: List[threading.Thread] = []
        self._stderr_files: List = []
        self._step_seq = 0
        self._step_payload = None
        self._step_sent = [0] * self.G
        self._stepdone = 0
        self._shutdown = False
        self._ready = [False] * self.G

    def _build_kernels(self) -> Optional[str]:
        """Build the draw's and the solver's kernels before the workers start
        (they would otherwise race to build them); returns the build dir."""
        from ..kernels import nvcc

        if self.device.type == "cuda":
            from ..kernels import prng as prng_kernels, sdca

            sources = list(prng_kernels.SOURCES)
            if get_backend(self.cfg.solver).uses_pallas:
                sources += sdca.SOURCES
            nvcc.build_all(sources)
        return str(nvcc.BUILD_DIR)

    def _ensure_workers(self):
        if self._procs:
            return
        with span("start_workers", cat="transport", workers=self.G):
            self._start_workers()

    def _start_workers(self):
        """Spawn the workers, send each its block, and wait until every one
        has it on its device and asks for work."""
        build_dir = self._build_kernels()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(self.G)
        port = self._listener.getsockname()[1]
        src_root = str(Path(__file__).resolve().parents[2])
        for g in range(self.G):
            env = dict(os.environ)
            env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
            env["REPRO_MP_ADDR"] = f"127.0.0.1:{port}"
            env["REPRO_MP_WORKER"] = str(g)
            errf = tempfile.TemporaryFile()
            self._stderr_files.append(errf)
            self._procs.append(
                subprocess.Popen(
                    [
                        sys.executable,
                        "-c",
                        "from repro_torch.core.transport import _mp_worker_main; "
                        "_mp_worker_main()",
                    ],
                    env=env,
                    stdout=subprocess.DEVNULL,
                    stderr=errf,
                )
            )
        self._listener.settimeout(120.0)
        for _ in range(self.G):
            conn, _addr = self._listener.accept()
            tag, g = _recv_msg(conn)
            if tag != "hello":
                raise RuntimeError(f"multiprocess worker sent {tag!r} before hello")
            rows = self._rows(g)
            _send_msg(
                conn,
                (
                    "init",
                    dict(
                        cfg=self.cfg,
                        x=_host(self.data.x[rows]),
                        y=_host(self.data.y[rows]),
                        n=_host(self.data.n[rows]),
                        tids=np.arange(rows.start, rows.stop, dtype=np.int32),
                        n_max=self.data.n_max,
                        R=self.R,
                        sleep_s=self.pace * self.delays[g],
                        device=str(self.device),
                        build_dir=build_dir,
                    ),
                ),
            )
            self._conns[g] = conn
            h = threading.Thread(
                target=self._serve_conn, args=(g, conn),
                name=f"dmtrl-ps-conn-{g}", daemon=True,
            )
            self._handlers.append(h)
            h.start()
        with self.cond:
            while not all(self._ready):
                self._check_abort()
                self._check_procs()
                self.cond.wait(timeout=0.1)

    def _serve_conn(self, g: int, conn: socket.socket):
        dev = self.device
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if op == "next":
                    with self.cond:
                        if not self._ready[g]:
                            self._ready[g] = True
                            self.cond.notify_all()
                        while self._step_seq <= self._step_sent[g] and not self._shutdown:
                            self.cond.wait(timeout=0.1)
                        if self._shutdown and self._step_seq <= self._step_sent[g]:
                            _send_msg(conn, ("done",))
                            return
                        self._step_sent[g] = self._step_seq
                        payload = self._step_payload
                    _send_msg(conn, ("wstep", payload))
                elif op == "gate":
                    self.gate(g, msg[1])
                    _send_msg(conn, ("ok",))
                elif op == "snapshot":
                    # codec-encoded payload dict: (W, Sigma) through the
                    # wire codec, alpha elided once the worker caches it
                    # (``have_alpha`` rides on the request)
                    have_alpha = bool(msg[1]) if len(msg) > 1 else False
                    _send_msg(conn, ("snap", self._encode_snapshot(g, have_alpha)))
                elif op == "commit":
                    r, dalpha, db_wire = msg[1], msg[2], msg[3]
                    if isinstance(db_wire, Encoded):
                        db = self.codec.decode(db_wire)
                        nb = db_wire.nbytes
                    else:
                        db = np.asarray(db_wire)
                        nb = int(db.nbytes)
                    with self.lock:
                        self.wire_stats["n_commits"] += 1
                        self.wire_stats["raw_commit_bytes"] += int(db.nbytes)
                        self.wire_stats["commit_bytes"] += nb
                    rc = self.commit(
                        g, r,
                        (torch.as_tensor(dalpha, device=dev), torch.as_tensor(db, device=dev)),
                    )
                    _send_msg(conn, ("receipt", rc.staleness, rc.lag, rc.version))
                elif op == "stepdone":
                    with self.cond:
                        self._stepdone += 1
                        self.cond.notify_all()
                    _send_msg(conn, ("ok",))
                elif op == "error":
                    raise RuntimeError(f"worker {g} failed:\n{msg[1]}")
                elif op == "bye":
                    return
                else:  # pragma: no cover - protocol guard
                    raise RuntimeError(f"unknown transport op {op!r}")
        except Exception as e:
            if not self._shutdown:
                self._fail(e)

    def _check_procs(self):
        for g, proc in enumerate(self._procs):
            if proc.poll() is not None and not self._shutdown:
                errf = self._stderr_files[g]
                errf.seek(0)
                tail = errf.read()[-2000:].decode(errors="replace")
                exc = RuntimeError(
                    f"multiprocess worker {g} died (returncode {proc.returncode}):\n{tail}"
                )
                # route through abort so handler threads parked in gate()
                # unwind instead of waiting on a floor that never advances
                self._fail(exc)
                raise exc

    def run_w_step(self, p, rho, outer_key):
        self._ensure_workers()
        self._begin_w_step(p)
        round_keys = prng.split(outer_key, self.R).numpy()
        with self.cond:
            self._step_seq += 1
            self._step_payload = dict(p=p, rho=float(rho), round_keys=round_keys)
            self._stepdone = 0
            self.cond.notify_all()
            while self._stepdone < self.G:
                self._check_abort()
                self._check_procs()
                self.cond.wait(timeout=0.2)
        self._end_w_step()

    def close(self):
        with self.cond:
            self._shutdown = True
            self.cond.notify_all()
        for h in self._handlers:
            h.join(timeout=10.0)
        for conn in self._conns.values():
            try:
                conn.close()
            except OSError:
                pass
        if self._listener is not None:
            self._listener.close()
        with span("stop_workers", cat="transport", workers=len(self._procs)):
            for proc in self._procs:
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for errf in self._stderr_files:
            errf.close()
        self._procs, self._handlers, self._conns = [], [], {}


def _mp_worker_main():  # pragma: no cover - runs in worker subprocesses
    """Entry point of a multiprocess-transport worker process: connect to
    the parameter server named by REPRO_MP_ADDR, receive this worker's
    task block, then loop gate -> snapshot -> local solve -> commit."""
    import traceback

    host, port = os.environ["REPRO_MP_ADDR"].rsplit(":", 1)
    g = int(os.environ["REPRO_MP_WORKER"])
    sock = socket.create_connection((host, int(port)), timeout=300.0)
    try:
        _send_msg(sock, ("hello", g))
        tag, init = _recv_msg(sock)
        if tag != "init":
            raise RuntimeError(f"expected init from the server, got {tag!r}")
        if init.get("build_dir"):
            from ..kernels import nvcc

            nvcc.BUILD_DIR = Path(init["build_dir"])
        dev = torch.device(init.get("device", "cpu"))
        cfg: DMTRLConfig = init["cfg"]
        x = torch.as_tensor(init["x"], device=dev)
        y = torch.as_tensor(init["y"], device=dev)
        n = torch.as_tensor(init["n"], device=dev)
        tids = torch.as_tensor(init["tids"], dtype=torch.int64)
        R, sleep_s = init["R"], init["sleep_s"]
        codec = get_codec(getattr(cfg, "codec", "none"))
        commit_ef = ErrorFeedback(codec)
        # worker-side alpha mirror under lossy codecs: alpha ships once,
        # then the worker replays its own exact eta*dalpha f32 adds — the
        # arithmetic the server performs, so the mirror stays equal to the
        # server state and alpha never rides the wire again
        alpha_loc: Optional[np.ndarray] = None
        while True:
            _send_msg(sock, ("next",))
            msg = _recv_msg(sock)
            if msg[0] == "done":
                break
            payload = msg[1]
            solve = make_block_solver(cfg, init["n_max"], payload["rho"])
            round_keys = torch.as_tensor(payload["round_keys"])
            for r in range(R):
                _send_msg(sock, ("gate", r))
                _recv_msg(sock)
                have_alpha = codec.name != "none" and alpha_loc is not None
                _send_msg(sock, ("snapshot", have_alpha))
                _tag, snap_payload = _recv_msg(sock)
                snap = decode_snapshot_payload(snap_payload, codec)
                if snap.alpha_rows is not None:
                    alpha_loc = np.asarray(snap.alpha_rows, dtype=np.float32)
                sig = snap.sigma_rows if snap.sigma_rows is not None else snap.sigma_diag
                dalpha, db = solve(
                    x, y, torch.as_tensor(alpha_loc, device=dev),
                    torch.as_tensor(snap.W_rows, device=dev), n,
                    torch.as_tensor(sig, device=dev), tids, round_keys[r],
                )
                dalpha, db = _host(dalpha), _host(db)
                if sleep_s:
                    time.sleep(sleep_s)
                if codec.name == "none":
                    db_wire = db
                else:
                    db_wire = commit_ef.encode("db", db)
                    # replay the server's alpha update in identical f32
                    # arithmetic so next round's have_alpha elision holds
                    alpha_loc = np.asarray(
                        alpha_loc + np.float32(cfg.eta) * dalpha, dtype=np.float32
                    )
                _send_msg(sock, ("commit", r, dalpha, db_wire))
                _recv_msg(sock)
            _send_msg(sock, ("stepdone",))
            _recv_msg(sock)
        _send_msg(sock, ("bye",))
    except Exception:
        try:
            _send_msg(sock, ("error", traceback.format_exc()))
        except OSError:
            pass
        raise
    finally:
        sock.close()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """A named way to run the snapshot/commit protocol."""

    name: str
    description: str
    needs_mesh: bool
    factory: Callable[[], Transport]


_REGISTRY: Dict[str, TransportSpec] = {}


def register_transport(spec: TransportSpec) -> TransportSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_transport(name: str) -> TransportSpec:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown transport {name!r}; have {sorted(_REGISTRY)}") from e


def available_transports() -> Dict[str, TransportSpec]:
    return dict(sorted(_REGISTRY.items()))


register_transport(
    TransportSpec(
        name="simulated",
        description="deterministic clock simulation with one masked SPMD tick "
        "per commit event over a mesh of process groups; bit-reproducible",
        needs_mesh=True,
        factory=SimulatedTransport,
    )
)
register_transport(
    TransportSpec(
        name="threaded",
        description="real in-host parameter server: G worker threads over "
        "lock-protected versioned state; nondeterministic arrival order, "
        "SSP-gate-correct",
        needs_mesh=False,
        factory=ThreadedTransport,
    )
)
register_transport(
    TransportSpec(
        name="multiprocess",
        description="socket/pickle parameter-server shim with per-worker "
        "processes on localhost (the cross-host RPC shape)",
        needs_mesh=False,
        factory=MultiprocessTransport,
    )
)

# the gossip member lives in its own module (core/gossip.py) and registers
# itself on import; importing it HERE — after every name it needs from this
# module exists — keeps `get_transport("gossip")` working without the
# caller having to know about the submodule, cycle-free
from . import gossip as _gossip_registration  # noqa: E402,F401
