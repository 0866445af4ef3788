"""Multi-replica serving fleet: task-affinity router over N schedulers.

The port of the JAX package's ``repro.serve.fleet``: pure Python over
the schedulers, so the routing, shedding, failover and rolling hot-swap
are the reference's line for line. (The transports named below are not
ported yet; an estimator push reaches the router the same way.)

One ``ContinuousBatchingScheduler`` is one host.  The ``FleetRouter``
fronts N of them — each replica a scheduler over its own engine holding
its own copy of the model — and adds the four things a fleet needs that a
single queue cannot provide:

  * **per-task affinity dispatch** — tasks are pinned to replicas by
    consistent hashing (a 64-bit ring with virtual nodes), so a task's
    requests keep landing where its hot per-task state (compiled tiles,
    cached Sigma rows) already lives; when the home replica's backlog runs
    ahead of the fleet, the request **spills to the least-loaded replica**
    instead of queueing behind the hot spot,
  * **deadline-aware load shedding** — the router estimates each
    candidate's queue delay (``ceil(backlog / batch) * tile_cost_s``) and,
    when EVERY candidate's estimate exceeds the request's budget (its
    relative deadline, else the router ``slo_s``), rejects at the door
    with an explicit ``SubmitOutcome(reason="shed")`` instead of admitting
    a guaranteed SLO violation.  Shed is **not** an SLO violation: the
    client got synchronous back-pressure and can retry; ``expired`` means
    the fleet accepted work it then failed — that one always counts,
  * **replica health** — a replica whose ``step()`` raises (or that an
    operator fails explicitly) is marked down; its backlog — including the
    tile the scheduler re-queued on the failure — is drained and re-pinned
    onto the survivors with original arrival stamps intact, and the hash
    ring routes around it until ``restore_replica`` brings it back
    (catching its model up to the fleet version first),
  * **rolling snapshot hot-swap with a monotonic-read guarantee** —
    ``publish_weights(W, sigma, version)`` has exactly the transport
    subscription signature, so ``transport.subscribe(router.publish_weights)``
    makes the router a second subscriber tier over the whole fleet.  A
    publish installs on ONE replica immediately and on one more per
    ``step()`` (the rolling swap: most of the fleet keeps serving the old
    snapshot while the new one warms through), and a per-client
    ``ClientToken`` carries ``min_version`` so a client is only ever
    routed to replicas at or past the newest version it has observed —
    ``ModelSnapshot.version`` never regresses for a client even mid-roll.
    If no live replica satisfies the token (its home died mid-roll), the
    router pulls the roll forward: it installs the latest snapshot on a
    survivor right then instead of rejecting.

The guarantee is the session kind: monotonic reads for SEQUENTIAL
requests per token (submit after observing the previous completion).
Publishes must flow through the router — it owns the fleet's version
space and restamps external counters into it, exactly like a single
scheduler's ``publish_weights`` — so every replica serves the same
strictly-increasing version sequence.

The router is time-agnostic: replicas and router share one injectable
clock (``VirtualClock`` for deterministic fleet sims — crash/restart,
rolling swap under load, Zipf-skewed traffic in
the JAX package's ``benchmarks/bench_fleet.py``), and ``step()`` steps every live replica
once, which models replicas running in parallel when the caller advances
the shared clock once per round.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import logging
import threading
from typing import Dict, List, Optional, Sequence

from .metrics import ServingMetrics
from ..obs.metrics import publish_serving_metrics
from ..obs.trace import span

logger = logging.getLogger(__name__)
from .scheduler import (
    ContinuousBatchingScheduler,
    ModelSnapshot,
    QueueFull,
    ServeRequest,
    SubmitOutcome,
)


def _hash64(key: str) -> int:
    """Deterministic 64-bit point on the ring (blake2b; NOT Python's
    salted ``hash``, so placements are stable across processes/runs)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
    )


class ClientToken:
    """Per-client monotonic-read session token.

    ``min_version`` is the newest ``ModelSnapshot.version`` this client
    has observed on a completion; the router only admits the client's next
    request to replicas at or past it.  ``observe`` is called by
    ``FleetRouter.step`` for every completion carrying the token — clients
    never need to touch it, only hand the same token to every ``submit``
    of one logical session.
    """

    __slots__ = ("min_version", "_lock")

    def __init__(self, min_version: int = 0):
        self.min_version = int(min_version)
        self._lock = threading.Lock()

    def observe(self, version: Optional[int]) -> None:
        if version is None:
            return
        with self._lock:
            if version > self.min_version:
                self.min_version = int(version)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ClientToken(min_version={self.min_version})"


@dataclasses.dataclass
class ReplicaHandle:
    """One fleet member: a scheduler plus its health bookkeeping."""

    id: int
    scheduler: ContinuousBatchingScheduler
    up: bool = True
    restarts: int = 0
    last_error: Optional[str] = None


class FleetRouter:
    """Task-affinity router over N ``ContinuousBatchingScheduler`` replicas.

    Parameters
    ----------
    replicas : the fleet members, homogeneous engines (same W shape, same
        ``batch``); replica i's id is its index.
    slo_s : default shed budget for requests submitted WITHOUT a deadline
        (a request's own relative deadline wins).  None + no deadline =
        that request is never shed.
    tile_cost_s : estimated service time of one tile, the unit of the
        router's queue-delay estimate.  None disables estimate-based
        shedding (bounded queues still reject).  When the router observes
        real (clock-visible) step durations it refines this with an EWMA.
    spill_depth : home-replica backlog (pending requests) beyond which a
        request may spill to the least-loaded candidate; default
        ``2 * batch``.
    vnodes : virtual nodes per replica on the hash ring (placement
        smoothness; 64 keeps the max/mean task load ratio low).
    """

    def __init__(
        self,
        replicas: Sequence[ContinuousBatchingScheduler],
        *,
        slo_s: Optional[float] = None,
        tile_cost_s: Optional[float] = None,
        spill_depth: Optional[int] = None,
        vnodes: int = 64,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self._handles = [
            ReplicaHandle(id=i, scheduler=s) for i, s in enumerate(replicas)
        ]
        self.slo_s = slo_s
        self.tile_cost_s = tile_cost_s
        batch = int(replicas[0].engine.batch)
        self.spill_depth = (
            int(spill_depth) if spill_depth is not None else 2 * batch
        )
        if self.spill_depth < 1:
            raise ValueError(f"spill_depth must be >= 1, got {self.spill_depth}")
        self._task_key = getattr(
            replicas[0].engine, "task_key", lambda r: None
        )
        self.clock = replicas[0].clock
        # consistent-hash ring: vnodes points per replica, sorted once
        self._ring = sorted(
            (_hash64(f"replica:{h.id}:vnode:{v}"), h.id)
            for h in self._handles
            for v in range(vnodes)
        )
        self._ring_points = [p for p, _ in self._ring]
        # the fleet's version space: _latest is the newest snapshot any
        # replica may serve; rolling swaps converge every UP replica to it
        self._latest: ModelSnapshot = max(
            (h.scheduler.snapshot for h in self._handles),
            key=lambda s: s.version,
        )
        self._version = self._latest.version
        self._lock = threading.RLock()
        self.counters: Dict[str, int] = {
            "submitted": 0,
            "admitted": 0,
            "spills": 0,
            "shed": 0,
            "queue_full": 0,
            "no_replica": 0,
            "expired_at_door": 0,
            "publishes": 0,
            "rolled_installs": 0,
            "pull_forwards": 0,
            "failovers": 0,
            "requeued": 0,
            "requeue_shed": 0,
            "restarts": 0,
        }

    # -- introspection ------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self._handles)

    @property
    def n_up(self) -> int:
        return sum(1 for h in self._handles if h.up)

    @property
    def version(self) -> int:
        """The fleet's target version (the roll converges every up replica
        to it; individual replicas may still be behind mid-roll)."""
        with self._lock:
            return self._version

    @property
    def pending(self) -> int:
        return sum(h.scheduler.pending for h in self._handles)

    @property
    def in_flight(self) -> int:
        return sum(h.scheduler.in_flight for h in self._handles)

    def replica(self, rid: int) -> ReplicaHandle:
        return self._handles[rid]

    def session(self, min_version: int = 0) -> ClientToken:
        """A fresh monotonic-read token for one client session."""
        return ClientToken(min_version)

    def home_of(self, task: int) -> int:
        """Ring lookup only (ignores health/load): the replica id task
        traffic is pinned to while the fleet is healthy and balanced."""
        return self._chain(task)[0]

    # -- ring ---------------------------------------------------------------
    def _chain(self, task) -> List[int]:
        """Replica ids in ring order starting at ``task``'s successor:
        element 0 is the home, the rest the failover order."""
        h = _hash64(f"task:{task}")
        start = bisect.bisect_right(self._ring_points, h) % len(self._ring)
        chain: List[int] = []
        for i in range(len(self._ring)):
            rid = self._ring[(start + i) % len(self._ring)][1]
            if rid not in chain:
                chain.append(rid)
                if len(chain) == len(self._handles):
                    break
        return chain

    def _est_wait_s(self, h: ReplicaHandle) -> float:
        """Queue-delay estimate if one more request joined ``h``'s queue."""
        if not self.tile_cost_s:
            return 0.0
        batch = int(h.scheduler.engine.batch)
        tiles_ahead = h.scheduler.pending // batch + 1
        return tiles_ahead * self.tile_cost_s

    def _pick(
        self, task, candidates: List[ReplicaHandle], *, count_spill: bool
    ) -> ReplicaHandle:
        """Affinity target among ``candidates``: the first chain member
        present, unless its backlog warrants a spill to the least loaded."""
        least = min(candidates, key=lambda h: (h.scheduler.pending, h.id))
        if task is None:
            return least
        by_id = {h.id: h for h in candidates}
        home = next(
            (by_id[rid] for rid in self._chain(task) if rid in by_id), least
        )
        if (
            home.scheduler.pending >= self.spill_depth
            and least.scheduler.pending < home.scheduler.pending
        ):
            if count_spill:
                self.counters["spills"] += 1
            return least
        return home

    # -- ingress ------------------------------------------------------------
    def submit(
        self,
        req: ServeRequest,
        *,
        deadline_s: Optional[float] = None,
        client: Optional[ClientToken] = None,
    ) -> SubmitOutcome:
        """Route one request: affinity + spill + monotonic-read filter +
        shed.  Never raises for capacity — rejects come back as explicit
        ``SubmitOutcome``s (``shed`` / ``queue_full`` / ``no_replica`` /
        ``expired``), unlike a bare scheduler's ``QueueFull``."""
        with self._lock:
            return self._submit_locked(req, deadline_s, client)

    def submit_many(
        self,
        reqs: Sequence[ServeRequest],
        *,
        deadline_s: Optional[float] = None,
        client: Optional[ClientToken] = None,
    ) -> List[SubmitOutcome]:
        return [
            self.submit(r, deadline_s=deadline_s, client=client) for r in reqs
        ]

    def _submit_locked(self, req, deadline_s, client) -> SubmitOutcome:
        self.counters["submitted"] += 1
        up = [h for h in self._handles if h.up]
        if not up:
            req.status = "shed"
            self.counters["no_replica"] += 1
            return SubmitOutcome(request=req, admitted=False, reason="no_replica")
        minv = client.min_version if client is not None else 0
        candidates = [h for h in up if h.scheduler.version >= minv]
        if not candidates:
            # monotonic-read pull-forward: every replica at this client's
            # version died mid-roll; install the latest snapshot (whose
            # version is >= anything any client ever observed) on a
            # survivor NOW instead of rejecting
            h = min(up, key=lambda h: (h.scheduler.pending, h.id))
            self._install_locked(h, self._latest)
            self.counters["pull_forwards"] += 1
            candidates = [h]
        budget = deadline_s if deadline_s is not None else self.slo_s
        if budget is not None and self.tile_cost_s:
            if min(self._est_wait_s(h) for h in candidates) > budget:
                req.status = "shed"
                self.counters["shed"] += 1
                return SubmitOutcome(request=req, admitted=False, reason="shed")
        task = self._task_key(req)
        target = self._pick(task, candidates, count_spill=True)
        order = [target] + sorted(
            (h for h in candidates if h is not target),
            key=lambda h: (h.scheduler.pending, h.id),
        )
        for h in order:
            try:
                r = h.scheduler.submit(req, deadline_s=deadline_s)
            except QueueFull:
                continue
            if r.status == "expired":
                self.counters["expired_at_door"] += 1
                return SubmitOutcome(
                    request=req, admitted=False, reason="expired", replica=h.id
                )
            if client is not None:
                req._fleet_client = client
            self.counters["admitted"] += 1
            return SubmitOutcome(request=req, admitted=True, replica=h.id)
        # every candidate's bounded queue rejected: scheduler-level shed
        req.status = "shed"
        self.counters["queue_full"] += 1
        return SubmitOutcome(request=req, admitted=False, reason="queue_full")

    # -- model publish (rolling hot-swap) -----------------------------------
    def publish_weights(
        self, W, sigma=None, version: Optional[int] = None
    ) -> int:
        """Install a new model FLEET-wide as a rolling swap.

        Exactly the ``core.transport`` subscription signature
        (``callback(W, sigma, version)``), so the router is a drop-in
        second subscriber tier: ``transport.subscribe(router.publish_weights)``
        rolls every training install across the fleet; so is an estimator
        push (``est.serving_fleet`` registers the router the same way it
        registers single schedulers).  External version counters are
        restamped into the fleet's monotone version space when not ahead
        of it.  The snapshot lands on ONE replica immediately; each
        subsequent ``step()`` converges one more replica, so the fleet
        keeps serving throughout.  Returns the fleet version installed.
        """
        # shape-check eagerly so a bad publish fails the publisher, not a
        # later roll step
        validate = getattr(
            self._handles[0].scheduler.engine, "validate_snapshot", None
        )
        if validate is not None:
            validate(ModelSnapshot(version=0, W=W, sigma=sigma))
        with self._lock:
            cur = max(
                [self._version]
                + [h.scheduler.version for h in self._handles]
            )
            v = int(version) if version is not None else cur + 1
            if v <= cur:
                v = cur + 1
            self._version = v
            self._latest = ModelSnapshot(version=v, W=W, sigma=sigma)
            self.counters["publishes"] += 1
            self._advance_roll_locked()
        return v

    def publish(self, snapshot: ModelSnapshot) -> int:
        """Snapshot-level publish convenience (delegates to the rolling
        ``publish_weights``; the version is restamped if not ahead)."""
        if not isinstance(snapshot, ModelSnapshot):
            raise TypeError(
                f"publish takes a ModelSnapshot, got {type(snapshot).__name__}"
            )
        return self.publish_weights(
            snapshot.W, snapshot.sigma, version=snapshot.version
        )

    def _install_locked(self, h: ReplicaHandle, snap: ModelSnapshot) -> None:
        if h.scheduler.version < snap.version:
            h.scheduler.publish(snap)
            self.counters["rolled_installs"] += 1

    def _advance_roll_locked(self) -> bool:
        """Converge ONE lagging up replica to the latest snapshot."""
        for h in self._handles:
            if h.up and h.scheduler.version < self._latest.version:
                self._install_locked(h, self._latest)
                return True
        return False

    @property
    def roll_pending(self) -> int:
        """Up replicas still behind the fleet version (0 = roll complete)."""
        with self._lock:
            return sum(
                1
                for h in self._handles
                if h.up and h.scheduler.version < self._latest.version
            )

    # -- health -------------------------------------------------------------
    def fail_replica(self, rid: int, error: Optional[str] = None) -> int:
        """Mark a replica dead and fail its backlog over to the survivors
        (the same path ``step()`` takes when a replica raises).  Returns
        the number of requests re-pinned."""
        with self._lock:
            return self._fail_locked(self._handles[rid], error or "failed by operator")

    def _fail_locked(self, h: ReplicaHandle, error: str) -> int:
        with span("failover", cat="serve", replica=h.id):
            return self._fail_over(h, error)

    def _fail_over(self, h: ReplicaHandle, error: str) -> int:
        if not h.up:
            return 0
        h.up = False
        h.last_error = error
        self.counters["failovers"] += 1
        stranded = h.scheduler.drain_queue()
        logger.warning(
            "replica %d failed at snapshot version %d (%s); failing over "
            "%d stranded request(s)",
            h.id,
            h.scheduler.version,
            error,
            len(stranded),
        )
        moved = 0
        for req in stranded:
            client = getattr(req, "_fleet_client", None)
            minv = client.min_version if client is not None else 0
            up = [x for x in self._handles if x.up]
            candidates = [x for x in up if x.scheduler.version >= minv]
            if not candidates and up:
                x = min(up, key=lambda h: (h.scheduler.pending, h.id))
                self._install_locked(x, self._latest)
                self.counters["pull_forwards"] += 1
                candidates = [x]
            placed = False
            if candidates:
                target = self._pick(
                    self._task_key(req), candidates, count_spill=False
                )
                order = [target] + sorted(
                    (x for x in candidates if x is not target),
                    key=lambda x: (x.scheduler.pending, x.id),
                )
                for x in order:
                    try:
                        if x.scheduler.requeue([req]):
                            moved += 1
                        # an empty requeue result = expired in transit:
                        # accounted by the receiving queue, not shed
                        placed = True
                        break
                    except QueueFull:
                        continue
            if not placed:
                req.status = "shed"
                self.counters["requeue_shed"] += 1
        self.counters["requeued"] += moved
        return moved

    def restore_replica(self, rid: int) -> None:
        """Bring a dead replica back: catch its model up to the fleet
        version FIRST (a revived replica must never serve a snapshot a
        client could have moved past), then rejoin the ring."""
        with self._lock:
            h = self._handles[rid]
            if h.up:
                return
            self._install_locked(h, self._latest)
            h.up = True
            h.last_error = None
            h.restarts += 1
            self.counters["restarts"] += 1
            logger.info(
                "replica %d restored at snapshot version %d (restart #%d)",
                h.id,
                h.scheduler.version,
                h.restarts,
            )

    # -- serving ------------------------------------------------------------
    def step(self) -> List[ServeRequest]:
        """One fleet round: advance the rolling swap by one replica, step
        every live replica once (replicas run in parallel — a caller on a
        virtual clock advances time once per round, not per replica), fail
        over any replica whose engine raised, and return everything that
        completed.  Completions update their clients' monotonic-read
        tokens before the requests are handed back."""
        with span("fleet_step", cat="serve", replicas=self.n_up):
            with self._lock:
                self._advance_roll_locked()
                handles = [h for h in self._handles if h.up]
            done: List[ServeRequest] = []
            for h in handles:
                try:
                    done.extend(h.scheduler.step())
                except Exception as exc:  # replica crash: fail over, keep serving
                    with self._lock:
                        self._fail_locked(h, repr(exc))
            for r in done:
                client = getattr(r, "_fleet_client", None)
                if client is not None:
                    client.observe(r.snapshot_version)
            return done

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Step until every queue drains; returns requests completed."""
        total = 0
        for _ in range(max_steps):
            n = len(self.step())
            total += n
            if not n and not self.pending and not self.in_flight:
                break
        return total

    def warmup(self) -> None:
        """Warm every replica engine ahead of traffic.  Homogeneous MTL
        replicas capture ONCE: the first engine records its CUDA graph, the
        rest adopt it (``MTLScoringEngine.adopt_warmup``)."""
        donor = None
        for h in self._handles:
            eng = h.scheduler.engine
            adopt = getattr(eng, "adopt_warmup", None)
            if donor is not None and adopt is not None and adopt(donor):
                continue
            warm = getattr(eng, "warmup", None)
            if warm is not None:
                warm()
                if donor is None:
                    donor = eng

    # -- rollup -------------------------------------------------------------
    def metrics(self) -> ServingMetrics:
        """Fleet-level metrics: every replica's counters/histograms merged
        (``ServingMetrics.merge``) into one point-in-time rollup."""
        per = [h.scheduler.metrics for h in self._handles]
        return per[0].merge(*per[1:]) if len(per) > 1 else per[0]

    def publish_metrics(self, registry=None) -> None:
        """Bridge the fleet's ServingMetrics into the obs registry:
        the merged rollup as ``replica="all"`` plus one labeled series
        per replica — the machine-readable autoscaling signals."""
        publish_serving_metrics(self.metrics(), replica="all", registry=registry)
        for h in self._handles:
            publish_serving_metrics(
                h.scheduler.metrics, replica=str(h.id), registry=registry
            )

    def summary(self) -> Dict[str, object]:
        """JSON-ready fleet record: router counters + merged replica
        metrics + per-replica health (the ``BENCH_fleet.json`` row shape)."""
        with self._lock:
            return {
                "replicas": self.n_replicas,
                "up": self.n_up,
                "version": self._version,
                "roll_pending": sum(
                    1
                    for h in self._handles
                    if h.up and h.scheduler.version < self._latest.version
                ),
                "router": dict(self.counters),
                "fleet": self.metrics().summary(),
                "per_replica": [
                    {
                        "id": h.id,
                        "up": h.up,
                        "restarts": h.restarts,
                        "version": h.scheduler.version,
                        "pending": h.scheduler.pending,
                        "completed": h.scheduler.metrics.completed,
                        "expired": h.scheduler.metrics.expired,
                    }
                    for h in self._handles
                ],
            }
