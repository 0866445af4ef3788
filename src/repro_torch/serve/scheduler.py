"""Continuous-batching scheduler: one request queue for every serving engine.

``MTLScoringEngine.run`` (and the LM ``ServingEngine.run``) are blocking
all-at-once surfaces: the caller hands over a full request list and waits
for every tile. Production traffic does not arrive as lists — it arrives
as a *stream*, and the scheduler is the piece in between:

  * a shared request queue with arrival timestamps and optional absolute
    deadlines (``ServeRequest`` base fields every engine's request type
    inherits),
  * deadline-aware admission: a request whose deadline already passed is
    dropped at the door (and again at packing time) instead of wasting a
    tile slot — each drop is an SLO violation in the metrics,
  * dynamic tile packing: every ``step()`` fills ONE fixed-shape jitted
    tile (``engine.batch`` slots) from whatever is queued right now —
    EDF (earliest deadline first) or FIFO order — so late arrivals ride
    the next tile instead of waiting for a full batch to assemble,
  * versioned model hot-swap: ``publish(ModelSnapshot)`` switches the
    weights between tiles without draining the queue. A tile is packed
    against the snapshot current at pack time and COMPLETES on it even if
    a publish lands mid-tile, so every request is scored against exactly
    one well-defined model version (recorded in ``snapshot_version``).

The scheduler is engine-agnostic: anything with ``batch``,
``admit(req)``, ``model_snapshot()`` and ``run_tile(reqs, snapshot)``
(plus optional ``task_key(req)`` for per-task metrics) can sit behind it
— ``serve/mtl.py`` (MTL scoring) and ``serve/engine.py`` (LM decode)
both do. A streaming engine (one with ``decode_tick``, the LM
``ServingEngine``) runs one decode STEP per ``step()``: finished requests
drain out, queued ones are injected into free slots of the running batch,
and every occupied slot advances one token. Time is injectable (``clock=``), so tests and the load bench
drive it with a virtual clock; ``submit``/``publish`` are thread-safe so
a training loop (``DMTRLEstimator.partial_fit`` or a transport
subscription) can push snapshots while another thread serves.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from .metrics import ServingMetrics
from ..obs.trace import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """An immutable versioned model: what one tile is scored against.

    For the MTL scorer ``W`` (m, d) is the task-weight matrix (a tensor or
    an array) and ``sigma`` the task covariance that produced it — either
    a dense (m, m) tensor or, under a structured regularizer, a
    ``core.sigma_view.SigmaView`` carrying only the factors (a few KB at
    any m); consumers that need relatedness rows gather them sparsely
    (``MTLScoringEngine.sigma_rows_for``), scoring itself only reads W.
    Versions are strictly increasing — publishers (``DMTRLEstimator``
    installs, transport subscriptions) stamp them, consumers refuse to go
    backwards.
    """

    version: int
    W: Optional[Any] = None
    sigma: Optional[Any] = None


def owned(a):
    """A published W or dense Sigma as a copy its publisher cannot change.

    JAX arrays are immutable and ``jnp.asarray`` copies; a torch tensor or
    numpy array is neither, so a snapshot that kept the caller's object
    would serve whatever the caller later writes into it. Tensors and
    arrays are copied; a ``SigmaView`` (whose factors nothing updates in
    place) and None pass through."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    if isinstance(a, np.ndarray):
        return a.copy()
    return a


@dataclasses.dataclass(kw_only=True)
class ServeRequest:
    """Queue fields shared by every engine's request type.

    ``arrival_s``/``deadline_s``/``finish_s`` are absolute times on the
    scheduler's clock; ``deadline_s`` is optional (None = best effort).
    ``status`` walks new -> queued -> done | expired (| shed, when a
    ``serve.fleet.FleetRouter`` rejects at the door); ``snapshot_version``
    records the model version the request was scored against.
    """

    arrival_s: Optional[float] = None
    deadline_s: Optional[float] = None
    finish_s: Optional[float] = None
    first_token_s: Optional[float] = None
    status: str = "new"
    snapshot_version: Optional[int] = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_s is None or self.arrival_s is None:
            return None
        return self.finish_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (arrival -> first sampled token); only
        streaming engines stamp ``first_token_s``."""
        if self.first_token_s is None or self.arrival_s is None:
            return None
        return self.first_token_s - self.arrival_s


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the scheduler's bounded queue is full."""


@dataclasses.dataclass(frozen=True)
class SubmitOutcome:
    """Per-request admission result of a batch submit or a fleet routing
    decision.  ``admitted`` requests are queued somewhere; rejects carry a
    ``reason`` (``"queue_full"`` | ``"expired"`` | ``"shed"`` |
    ``"no_replica"``).  Behind a ``serve.fleet.FleetRouter``, ``replica``
    names the replica whose queue admitted the request."""

    request: ServeRequest
    admitted: bool
    reason: Optional[str] = None
    replica: Optional[int] = None


class VirtualClock:
    """Deterministic injectable scheduler clock (``clock=VirtualClock()``).

    Tests, the load bench and simulated-time demos advance it explicitly;
    latency/throughput metrics then measure virtual seconds exactly the
    way they measure wall seconds.  Thread-safe: fleet simulations share
    ONE clock between a router, N replica schedulers and trainer threads,
    so reads and advances are serialized under a lock.  Time never runs
    backwards — ``advance`` rejects negative steps and ``advance_to``
    rejects targets earlier than the current time.
    """

    def __init__(self, t: float = 0.0):
        self._t = float(t)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        with self._lock:
            self._t += float(dt)

    def advance_to(self, t: float) -> None:
        t = float(t)
        with self._lock:
            if t < self._t:
                raise ValueError(
                    f"advance_to target {t} is earlier than the current "
                    f"time {self._t}; virtual time never runs backwards"
                )
            self._t = t


_POLICIES = ("edf", "fifo")


class ContinuousBatchingScheduler:
    """Deadline-aware continuous-batching scheduler over one engine.

    Parameters
    ----------
    engine : the batch runner (``MTLScoringEngine`` / ``ServingEngine`` /
        anything with the adapter surface described in the module doc).
        Request validation happens ONCE, at admission (``engine.admit``).
    slo_s : latency SLO; a completed request with latency above it counts
        as an SLO violation (deadline misses always count).
    policy : ``"edf"`` packs earliest-deadline-first (deadline-less
        requests last, FIFO within ties); ``"fifo"`` packs in arrival
        order.
    max_queue : bounded queue; ``submit`` raises ``QueueFull`` beyond it
        (load shedding is the caller's policy, the drop is counted).
    clock : injectable time source (virtual clocks for tests/benches).
    """

    def __init__(
        self,
        engine,
        *,
        slo_s: Optional[float] = None,
        policy: str = "edf",
        max_queue: Optional[int] = None,
        metrics: Optional[ServingMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.engine = engine
        self.policy = policy
        self.max_queue = max_queue
        self.clock = clock
        self.metrics = metrics if metrics is not None else ServingMetrics(
            slo_s=slo_s, clock=clock
        )
        self._task_key = getattr(engine, "task_key", lambda r: None)
        # engines that care about snapshot shape expose validate_snapshot
        # (the MTL scorer rejects W-shape changes); LM engines don't
        self._validate_snapshot = getattr(
            engine, "validate_snapshot", lambda snap: None
        )
        self._snapshot: ModelSnapshot = engine.model_snapshot()
        self._engine_snap: ModelSnapshot = self._snapshot
        self._queue: List[ServeRequest] = []
        self._lock = threading.Lock()
        # streaming engines (serve/engine.py) expose a per-decode-step
        # surface; for them one step() = one decode STEP over the running
        # batch, not one whole-generation tile
        self._streaming = hasattr(engine, "decode_tick")

    # -- introspection ------------------------------------------------------
    @property
    def version(self) -> int:
        """Version of the snapshot the NEXT tile will be packed against."""
        with self._lock:
            return self._snapshot.version

    @property
    def snapshot(self) -> ModelSnapshot:
        with self._lock:
            return self._snapshot

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def in_flight(self) -> int:
        """Requests injected into a streaming engine's slot table and not
        yet finished (always 0 for whole-tile engines)."""
        return int(getattr(self.engine, "active", 0))

    # -- ingress ------------------------------------------------------------
    def submit(
        self, req: ServeRequest, *, deadline_s: Optional[float] = None
    ) -> ServeRequest:
        """Admit one request: validate, stamp arrival, enqueue.

        ``deadline_s`` is RELATIVE (seconds from now) and is written into
        ``req.deadline_s`` as an absolute time; a request arriving with
        its deadline already in the past is dropped as ``expired``.
        """
        self.engine.admit(req)  # the single validation point
        task = self._task_key(req)
        with self._lock:
            now = self.clock()
            req.arrival_s = now
            if deadline_s is not None:
                if deadline_s <= 0:
                    raise ValueError(
                        f"deadline_s must be positive, got {deadline_s}"
                    )
                req.deadline_s = now + deadline_s
            if req.deadline_s is not None and req.deadline_s < now:
                req.status = "expired"
                self.metrics.on_submit(task)
                self.metrics.on_expired(task)
                return req
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                self.metrics.on_reject(task)
                raise QueueFull(
                    f"queue is at max_queue={self.max_queue}; request rejected"
                )
            req.status = "queued"
            self._queue.append(req)
            self.metrics.on_submit(task)
            self.metrics.observe_queue_depth(len(self._queue))
        return req

    def submit_many(
        self, reqs: Sequence[ServeRequest], *, deadline_s: Optional[float] = None
    ) -> List[SubmitOutcome]:
        """Admit a batch: one ``SubmitOutcome`` per request, in order.

        Unlike ``submit``, a full queue does NOT raise — the offending
        request is reported as ``admitted=False, reason="queue_full"`` and
        the REST of the batch is still attempted (a mid-batch ``QueueFull``
        used to silently drop the remainder), so callers — and the fleet
        router — can retry or shed each reject deterministically.
        """
        out: List[SubmitOutcome] = []
        for r in reqs:
            try:
                r = self.submit(r, deadline_s=deadline_s)
            except QueueFull:
                out.append(
                    SubmitOutcome(request=r, admitted=False, reason="queue_full")
                )
                continue
            if r.status == "expired":
                out.append(
                    SubmitOutcome(request=r, admitted=False, reason="expired")
                )
            else:
                out.append(SubmitOutcome(request=r, admitted=True))
        return out

    # -- fleet failover hooks (serve/fleet.py) ------------------------------
    def drain_queue(self) -> List[ServeRequest]:
        """Remove and return every queued request, stamps intact.

        The fleet router calls this on a replica it just marked dead: the
        backlog (including any tile ``step`` re-queued on the engine
        failure) is re-pinned onto surviving replicas via ``requeue``.
        """
        with self._lock:
            drained, self._queue = self._queue, []
            self.metrics.observe_queue_depth(0)
            return drained

    def requeue(self, reqs: Sequence[ServeRequest]) -> List[ServeRequest]:
        """Re-admit requests ALREADY admitted once (fleet failover path).

        Arrival/deadline stamps survive (latency keeps counting from the
        ORIGINAL arrival), there is no re-validation and no second
        ``on_submit`` count — the request was counted at the replica that
        first admitted it.  Requests whose deadline passed in the meantime
        expire here (counted against THIS queue); the bounded queue still
        applies (``QueueFull`` admits none of the batch).  Returns the
        requests actually queued.
        """
        reqs = list(reqs)
        if not reqs:
            return []
        with self._lock:
            now = self.clock()
            live: List[ServeRequest] = []
            for r in reqs:
                if r.deadline_s is not None and r.deadline_s < now:
                    r.status = "expired"
                    self.metrics.on_expired(self._task_key(r))
                else:
                    live.append(r)
            if (
                self.max_queue is not None
                and len(self._queue) + len(live) > self.max_queue
            ):
                raise QueueFull(
                    f"requeue of {len(live)} requests would exceed "
                    f"max_queue={self.max_queue}"
                )
            for r in live:
                r.status = "queued"
            self._queue.extend(live)
            self.metrics.observe_queue_depth(len(self._queue))
        return live

    # -- model hot-swap -----------------------------------------------------
    def publish(self, snapshot: ModelSnapshot) -> int:
        """Install a new model snapshot for all FUTURE tiles.

        Tiles already packed complete on the snapshot they were packed
        against (no drain, no drop, no double-score). Versions are
        strictly increasing: re-delivering the CURRENT version is an
        idempotent no-op (at-least-once publishers are fine), an OLDER
        version raises. Returns the installed version.
        """
        if not isinstance(snapshot, ModelSnapshot):
            raise TypeError(
                f"publish takes a ModelSnapshot, got {type(snapshot).__name__}"
            )
        self._validate_snapshot(snapshot)
        with self._lock:
            if snapshot.version == self._snapshot.version:
                return snapshot.version
            if snapshot.version < self._snapshot.version:
                raise ValueError(
                    f"snapshot version {snapshot.version} is not newer than "
                    f"the installed version {self._snapshot.version}"
                )
            self._snapshot = snapshot
            self.metrics.on_swap(snapshot.version)
        return snapshot.version

    def publish_weights(self, W, sigma=None, version: Optional[int] = None) -> int:
        """Array-level publish — the shape a ``core.transport`` model
        subscription emits (``callback(W, sigma, version)``), so
        ``transport.subscribe(scheduler.publish_weights)`` wires live
        training commits straight into serving.

        Unlike the strict ``publish``, external version counters are
        RE-STAMPED into this scheduler's monotone version space when they
        are not ahead of it (a transport's install counter and an
        estimator's model version are independent sequences); the
        compute-and-install is one atomic lock acquisition, so concurrent
        publishers can never drop each other's weights. Returns the
        installed version."""
        self._validate_snapshot(ModelSnapshot(version=0, W=W, sigma=sigma))
        W, sigma = owned(W), owned(sigma)
        with self._lock:
            cur = self._snapshot.version
            v = int(version) if version is not None else cur + 1
            if v <= cur:
                v = cur + 1
            self._snapshot = ModelSnapshot(version=v, W=W, sigma=sigma)
            self.metrics.on_swap(v)
        return v

    # -- scheduling ---------------------------------------------------------
    def _expire_locked(self, now: float) -> None:
        keep: List[ServeRequest] = []
        for r in self._queue:
            if r.deadline_s is not None and r.deadline_s < now:
                r.status = "expired"
                self.metrics.on_expired(self._task_key(r))
            else:
                keep.append(r)
        self._queue = keep

    def _pickup_engine_snapshot_locked(self) -> None:
        # pick up snapshots pushed INTO the engine directly (e.g. an
        # estimator push to an engine this scheduler was composed
        # over). Detected by IDENTITY, not version: producer counters
        # are independent spaces, so an engine push can carry a lower
        # number than a scheduler counter that transport pushes ran
        # ahead — restamp it instead of ignoring it.
        eng_snap = self.engine.model_snapshot()
        if eng_snap is not self._engine_snap:
            self._engine_snap = eng_snap
            cur = self._snapshot.version
            # equal version = the same model delivered down both paths
            # (estimator pushes to engine AND scheduler): no-op
            if eng_snap.version != cur:
                v = eng_snap.version if eng_snap.version > cur else cur + 1
                self._snapshot = (
                    eng_snap
                    if v == eng_snap.version
                    else dataclasses.replace(eng_snap, version=v)
                )
                self.metrics.on_swap(v)

    def _sort_queue_locked(self) -> None:
        if self.policy == "edf":
            # stable sort: FIFO within equal (or absent) deadlines
            self._queue.sort(
                key=lambda r: (
                    r.deadline_s if r.deadline_s is not None else float("inf")
                )
            )

    def step(self) -> List[ServeRequest]:
        """Pack and run ONE tile; returns the completed requests.

        Whole-tile engines: packing (under the lock) drops expired
        requests, orders the queue by policy, takes up to
        ``engine.batch``, captures the current snapshot; execution
        (outside the lock) is ``engine.run_tile`` on the captured
        snapshot — concurrent ``publish``/``submit`` calls only affect
        later tiles. An empty queue returns [].

        Streaming engines (``decode_tick`` present): the tile unit is one
        decode STEP. Each step drains finished requests out of the slot
        table, injects up to ``engine.free_slots`` queued requests into
        the RUNNING batch (stamping time-to-first-token and the snapshot
        version they were admitted under — a request completes on that
        version even if a publish lands mid-generation), then advances
        every occupied slot one token. Returns whatever finished this
        step, possibly requests injected many steps ago.
        """
        if self._streaming:
            return self._step_streaming()
        with span("pack", cat="serve"), self._lock:
            now = self.clock()
            self._expire_locked(now)
            self._pickup_engine_snapshot_locked()
            if not self._queue:
                self.metrics.observe_queue_depth(0)
                return []
            self._sort_queue_locked()
            tile = self._queue[: self.engine.batch]
            del self._queue[: self.engine.batch]
            snap = self._snapshot
            self.metrics.observe_queue_depth(len(self._queue))
        try:
            with span("run_tile", cat="serve", tile=len(tile)):
                self.engine.run_tile(tile, snap)
        except BaseException:
            # never lose a packed tile: put the requests back at the head
            # of the queue (still "queued", timestamps intact) and let the
            # caller see the engine failure
            logger.warning(
                "run_tile failed on snapshot version %d; re-queuing %d "
                "packed request(s) at the head",
                snap.version,
                len(tile),
                exc_info=True,
            )
            with self._lock:
                self._queue[:0] = tile
            raise
        done_s = self.clock()
        # completion bookkeeping under the lock: metrics are also mutated
        # by concurrent submit()/publish() callers
        with self._lock:
            slo = self.metrics.slo_s
            for r in tile:
                r.status = "done"
                r.finish_s = done_s
                r.snapshot_version = snap.version
                lat = done_s - r.arrival_s
                violated = (slo is not None and lat > slo) or (
                    r.deadline_s is not None and done_s > r.deadline_s
                )
                self.metrics.on_complete(self._task_key(r), lat, violated)
            self.metrics.on_tile(len(tile), self.engine.batch)
        return tile

    def _step_streaming(self) -> List[ServeRequest]:
        # surface generations finished on earlier ticks and free their
        # slots BEFORE packing, so this step's injection sees them
        finished: List[ServeRequest] = list(self.engine.drain())
        with self._lock:
            now = self.clock()
            self._expire_locked(now)
            self._pickup_engine_snapshot_locked()
            take: List[ServeRequest] = []
            free = self.engine.free_slots
            if free and self._queue:
                self._sort_queue_locked()
                take = self._queue[:free]
                del self._queue[:free]
            snap = self._snapshot
            self.metrics.observe_queue_depth(len(self._queue))
        try:
            if take:
                # inject = per-request prefill + first sampled token:
                # time-to-first-token is paid here, and the request is
                # stamped with the snapshot it was ADMITTED under
                with span("inject", cat="serve", n=len(take)):
                    self.engine.inject(take, snap)
                t1 = self.clock()
                with self._lock:
                    for r in take:
                        r.status = "running"
                        r.first_token_s = t1
                        self.metrics.on_first_token(t1 - r.arrival_s)
                    self.metrics.on_tile(len(take), self.engine.batch)
            occupied = self.engine.active
            if occupied:
                with span("decode_step", cat="serve", occupied=occupied):
                    finished.extend(self.engine.decode_tick())
            with self._lock:
                self.metrics.on_decode_step(occupied, self.engine.batch)
        except BaseException:
            # never lose a request: evict everything in-flight (the next
            # inject resets per-attempt decode state) and requeue at the
            # head, then let the caller see the engine failure
            evicted = self.engine.evict_active()
            ids = {id(r) for r in evicted}
            back = evicted + [r for r in take if id(r) not in ids]
            logger.warning(
                "streaming step failed on snapshot version %d; evicted %d "
                "in-flight and re-queued %d request(s)",
                snap.version,
                len(evicted),
                len(back),
                exc_info=True,
            )
            with self._lock:
                for r in back:
                    r.status = "queued"
                self._queue[:0] = back
            raise
        done_s = self.clock()
        with self._lock:
            slo = self.metrics.slo_s
            for r in finished:
                r.status = "done"
                r.finish_s = done_s
                # snapshot_version was stamped at INJECT (admission), not
                # here: mid-generation publishes must not relabel it
                lat = done_s - r.arrival_s
                violated = (slo is not None and lat > slo) or (
                    r.deadline_s is not None and done_s > r.deadline_s
                )
                self.metrics.on_complete(self._task_key(r), lat, violated)
        return finished

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Step until the queue AND any streaming slot table drain;
        returns requests completed."""
        total = 0
        for _ in range(max_steps):
            done = self.step()
            if not done and not self.pending and not self.in_flight:
                break
            total += len(done)
        return total
