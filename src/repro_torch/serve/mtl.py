"""Batched MTL scoring: fixed-shape tiles over a hot-swappable W, replayed
as a CUDA graph on the card.

The port of the JAX package's ``repro.serve.mtl``. Requests carry
(task_id, feature vector); the engine packs them into fixed (batch, d)
tiles so ONE recorded computation serves every batch, gathers the
per-task weight rows, and returns raw scores plus +-1 labels for
classification models.

The engine serves a versioned ``ModelSnapshot`` (W, sigma, version) and
swaps it live: ``publish``/``swap`` install a new same-shape W without
recapturing (the captured tile reads W from a fixed buffer, refilled when
a tile is scored against another W), and ``refresh()`` pulls the newest
snapshot from the estimator that built the engine.

Where the JAX engine AOT-compiles the tile (``warmup``), this one records
it as a CUDA graph over static buffers W (m, d), X (batch, d), tasks
(batch,) and replays it per tile; a tile copies its rows in and its
scores out around the replay. The capture happens at ``warmup()`` or, like
a first jit call, at the first tile. On the CPU there is nothing to
capture and every tile runs the plain step. A W whose dtype differs from
the captured one (the case where the JAX engine leaves its AOT
executable for the jitted step) runs the plain step on the card too; a
failed capture or replay raises.

    eng = est.scoring_engine(batch=64)           # or MTLScoringEngine(W)
    done = eng.run([ScoreRequest(task=3, x=phi), ...])   # blocking batch
    sched = est.serving_scheduler(batch=64)      # continuous batching
    sched.submit(ScoreRequest(task=3, x=phi)); sched.step()

``run`` / ``run_tile`` / ``score_batch`` all validate through
``_validate_batch`` (task range + feature width) exactly once, and all
score through the same pad/tile loop.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dmtrl import resolve_device
from ..core.dual import task_scores
from ..core.sigma_view import SigmaView
from .scheduler import ModelSnapshot, ServeRequest

Tensor = torch.Tensor


@dataclasses.dataclass
class ScoreRequest(ServeRequest):
    """One scoring request: task id + feature vector (phi already applied).

    The engine fills ``score`` (raw margin w_task^T x) and, for
    classification models, ``label`` (+-1); the scheduler additionally
    stamps the queue fields inherited from ``ServeRequest`` (arrival,
    deadline, status, ``snapshot_version``).
    """

    task: int
    x: np.ndarray  # (d,)
    score: Optional[float] = None
    label: Optional[float] = None
    # filled by ``run_tile`` when the engine was built with
    # ``gather_sigma_rows=True`` and the packed snapshot carries a Sigma:
    # this request's task-relatedness row Sigma[task] (m,) — gathered
    # sparsely from the structured factors, never via a dense (m, m)
    sigma_row: Optional[np.ndarray] = None


def make_score_step():
    """score_step(W (m, d), X (B, d), tasks (B,)) -> (B,) margins.

    The estimator's predict path (core/dual.py:task_scores); mixed dtypes
    are promoted first, as JAX promotes them.
    """

    def score_step(W, X, tasks):
        dt = torch.promote_types(W.dtype, X.dtype)
        return task_scores(W.to(dt), X.to(dt), tasks)

    return score_step


def make_sigma_gather():
    """gather(sigma, tasks (B,)) -> (B, m) Sigma rows of a tile's tasks.

    A SigmaView gathers from its factors (O(B * m) work / output, no dense
    (m, m) ever); a dense Sigma is a plain row take.
    """

    def gather(sigma, tasks):
        if isinstance(sigma, SigmaView):
            return sigma.rows(tasks)
        return torch.as_tensor(sigma, device=tasks.device)[tasks]

    return gather


def _shape(W) -> tuple:
    return tuple(W.shape) if hasattr(W, "shape") else np.shape(W)


class ScoreGraph:
    """One captured score tile on the card.

    The fixed (batch, d) step recorded as a CUDA graph over static buffers
    ``W`` (m, d), ``X`` (batch, d), ``t`` (batch,) and its output ``z``.
    Replays share the buffers, so every use holds ``lock``; engines that
    adopted this capture (``MTLScoringEngine.adopt_warmup``) share it and
    its lock. ``loaded`` is the W object (tensor or array) whose values the
    W buffer holds: a tile scored against another W copies it in first.
    ``captures`` counts the graphs recorded in this process.
    """

    captures = 0

    def __init__(self, W: Tensor, batch: int):
        dev = W.device
        self.batch = int(batch)
        self.W = W.clone()
        self.X = torch.zeros((batch, W.shape[1]), dtype=torch.float32, device=dev)
        self.t = torch.zeros((batch,), dtype=torch.int64, device=dev)
        self.loaded = W
        self.lock = threading.Lock()
        step = make_score_step()
        # run the step outside the capture first: cuBLAS and the caching
        # allocator set themselves up on first use, which a capture forbids
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                step(self.W, self.X, self.t)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.z = step(self.W, self.X, self.t)
        ScoreGraph.captures += 1

    def score(self, key, W: Tensor, X: Tensor, t: Tensor) -> np.ndarray:
        """Scores of the padded tiles X (n, d), t (n,) against W, whose
        identity ``key`` (the snapshot's W object) says whether the W
        buffer already holds it."""
        out = torch.empty((X.shape[0],), dtype=torch.float32, device=X.device)
        with self.lock:
            if self.loaded is not key:
                self.W.copy_(W)
                self.loaded = key
            for lo in range(0, X.shape[0], self.batch):
                self.X.copy_(X[lo : lo + self.batch])
                self.t.copy_(t[lo : lo + self.batch])
                self.graph.replay()
                out[lo : lo + self.batch].copy_(self.z)
            return out.cpu().numpy()


class MTLScoringEngine:
    """Batched scorer over a versioned task-weight matrix W (m, d).

    Requests are packed into fixed-size (batch, d) tiles (the last tile is
    padded with task-0 zero rows) so the captured step is reused; the
    padding rows are dropped before results are written back. W lives on
    ``device`` (the CUDA card unless the caller passes ``device="cpu"``).
    Implements the scheduler adapter surface (``admit`` / ``run_tile`` /
    ``model_snapshot`` / ``task_key``) so it can sit behind a
    ``ContinuousBatchingScheduler``.
    """

    def __init__(
        self,
        W,
        batch: int = 32,
        classify: bool = True,
        *,
        version: int = 0,
        source=None,
        sigma=None,
        gather_sigma_rows: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        W = self._as_W(W)
        if W.ndim != 2:
            raise ValueError(f"W must be (m, d), got {tuple(W.shape)}")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.batch = int(batch)
        self.classify = bool(classify)
        self.gather_sigma_rows = bool(gather_sigma_rows)
        self._snapshot = ModelSnapshot(version=int(version), W=W, sigma=sigma)
        self._step = make_score_step()
        self._gather = make_sigma_gather()
        self._graph: Optional[ScoreGraph] = None  # captured by warmup()
        self._source = weakref.ref(source) if source is not None else None
        # serializes the swap surface (publish/swap/publish_weights/refresh)
        # and the capture against concurrent callers; scoring reads one
        # snapshot ref and needs no lock of its own
        self._swap_lock = threading.RLock()

    def _as_W(self, W) -> Tensor:
        """W as a tensor on the engine's device; float64 narrows to
        float32, as ``jnp.asarray`` does without x64."""
        W = torch.as_tensor(W, device=self.device)
        return W.float() if W.dtype == torch.float64 else W

    # -- model surface ------------------------------------------------------
    @property
    def W(self) -> Tensor:
        return self._snapshot.W

    @property
    def version(self) -> int:
        return self._snapshot.version

    @property
    def m(self) -> int:
        return int(self.W.shape[0])

    @property
    def d(self) -> int:
        return int(self.W.shape[1])

    def model_snapshot(self) -> ModelSnapshot:
        return self._snapshot

    def validate_snapshot(self, snapshot: ModelSnapshot) -> None:
        """Hot-swap admission: W must keep the serving shape so the
        captured step is reused and task ids stay valid. The scheduler
        calls this before installing any published snapshot."""
        shape = _shape(snapshot.W)
        if shape != tuple(self.W.shape):
            raise ValueError(
                f"hot-swap W shape {shape} != serving shape {tuple(self.W.shape)}"
            )

    def publish(self, snapshot: ModelSnapshot) -> int:
        """Install a newer (W, sigma, version); shape must match so the
        captured step is reused and task ids stay valid. Re-delivering the
        current version is an idempotent no-op; an older version raises."""
        self.validate_snapshot(snapshot)
        W = self._as_W(snapshot.W)
        with self._swap_lock:
            if snapshot.version == self._snapshot.version:
                return self._snapshot.version
            if snapshot.version < self._snapshot.version:
                raise ValueError(
                    f"snapshot version {snapshot.version} is not newer than "
                    f"the installed version {self._snapshot.version}"
                )
            self._snapshot = dataclasses.replace(snapshot, W=W)
            return self._snapshot.version

    def swap(self, W, sigma=None, version: Optional[int] = None) -> int:
        """Array-level hot-swap (auto-increments the version)."""
        with self._swap_lock:
            if version is None:
                version = self._snapshot.version + 1
            return self.publish(
                ModelSnapshot(version=int(version), W=W, sigma=sigma)
            )

    def publish_weights(self, W, sigma=None, version: Optional[int] = None) -> int:
        """Restamping array-level publish: an external producer's version
        counter (estimator model version, transport install counter) that
        is not ahead of this engine's is re-stamped into the engine's own
        monotone space, so a push from an independent producer ALWAYS
        installs its weights instead of colliding (same atomic
        compute-and-install contract as
        ``ContinuousBatchingScheduler.publish_weights``)."""
        with self._swap_lock:
            cur = self._snapshot.version
            v = int(version) if version is not None else cur + 1
            if v <= cur:
                v = cur + 1
            return self.publish(ModelSnapshot(version=v, W=W, sigma=sigma))

    def refresh(self) -> int:
        """Pull the newest snapshot from the estimator that built this
        engine (``DMTRLEstimator.scoring_engine``); no-op when already
        current. Returns the serving version."""
        est = self._source() if self._source is not None else None
        if est is None:
            raise RuntimeError(
                "refresh() needs an engine built by "
                "DMTRLEstimator.scoring_engine (no live source estimator)"
            )
        snap = est.model_snapshot()
        with self._swap_lock:
            if snap.version > self._snapshot.version:
                self.publish(snap)
            return self._snapshot.version

    def warmup(self) -> None:
        """Capture the fixed (batch, d) scoring tile as a CUDA graph ahead
        of traffic, so the first real request never pays the capture.
        Hot-swapped W of the same shape and dtype reuses the graph (it is
        copied into the graph's W buffer). A no-op on the CPU."""
        if self.device.type != "cuda":
            return
        with self._swap_lock:
            self._graph = ScoreGraph(self.W, self.batch)

    def adopt_warmup(self, other: "MTLScoringEngine") -> bool:
        """Share a sibling engine's captured graph instead of capturing
        again: homogeneous fleet replicas (same batch, same W shape, dtype
        and device) serve the identical fixed-shape step, so ONE capture
        warms the whole fleet (``FleetRouter.warmup``); they share its
        buffers and its lock. Returns False — and leaves this engine
        untouched — when the donor is cold or the shapes differ (caller
        falls back to ``warmup()``)."""
        g = other._graph
        if (
            g is None
            or g.batch != self.batch
            or tuple(g.W.shape) != tuple(self.W.shape)
            or g.W.dtype != self.W.dtype
            or g.W.device != self.W.device
        ):
            return False
        self._graph = g
        return True

    # -- validation (THE single point: every entry path lands here) ---------
    def _validate_batch(self, X, tasks) -> Tuple[np.ndarray, np.ndarray]:
        """Normalize + validate (X, tasks) once for run/run_tile/score_batch:
        feature width must be d, task ids in [0, m)."""
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu()
        if isinstance(tasks, torch.Tensor):
            tasks = tasks.detach().cpu()
        # writable (copied only when the caller's array is not), so the
        # rows go to the device without torch's read-only warning
        X = np.require(X, np.float32, "W")
        if X.ndim != 2 or X.shape[1] != self.d:
            raise ValueError(
                f"request feature shape {X.shape} does not pack to "
                f"(n, {self.d})"
            )
        t = np.array(np.broadcast_to(np.asarray(tasks, np.int32), (X.shape[0],)))
        if t.size and (t.min() < 0 or t.max() >= self.m):
            raise ValueError(
                f"task id out of range [0, {self.m}): [{t.min()}, {t.max()}]"
            )
        return X, t

    def admit(self, r: ScoreRequest) -> None:
        """Scheduler admission hook: validate ONE request through the same
        batch validator (a 1-row pack). A float vector of width d with an
        integer task id in range is accepted without it: the validator's
        numpy calls were most of a request's admission cost."""
        x, task = r.x, r.task
        if (
            isinstance(x, np.ndarray) and x.dtype.kind == "f" and x.shape == (self.d,)
            and isinstance(task, (int, np.integer)) and 0 <= task < self.m
        ):
            return
        x = np.asarray(x, np.float32)
        if x.ndim != 1:
            raise ValueError(f"request feature shape {x.shape} != ({self.d},)")
        self._validate_batch(x[None], np.asarray([int(r.task)]))

    def task_key(self, r: ScoreRequest) -> int:
        return int(r.task)

    # -- scoring (one pad/tile loop shared by every surface) ----------------
    def _score_tiles(self, X: np.ndarray, t: np.ndarray, W_key) -> np.ndarray:
        """Scores of X (n, d) against ``W_key`` (the snapshot's W, a tensor
        or an array) in fixed (batch, d) tiles."""
        n, B = X.shape[0], self.batch
        n_pad = n + (-n) % B
        W = self._as_W(W_key)
        # one host-to-device copy of the rows; the pad rows (task 0, zero
        # features) are written on the device, not copied on the host
        Xd = torch.zeros((n_pad, self.d), dtype=torch.float32, device=self.device)
        Xd[:n] = torch.from_numpy(X)
        td = torch.zeros((n_pad,), dtype=torch.int64, device=self.device)
        td[:n] = torch.from_numpy(t)
        if self.device.type == "cuda" and self._graph is None:
            # the first tile captures, as a first jit call compiles
            with self._swap_lock:
                if self._graph is None:
                    self.warmup()
        g = self._graph
        if g is not None and W.dtype == g.W.dtype:
            return g.score(W_key, W, Xd, td)[:n]
        out = torch.empty((n_pad,), dtype=torch.float32, device=self.device)
        for lo in range(0, n_pad, B):
            out[lo : lo + B] = self._step(W, Xd[lo : lo + B], td[lo : lo + B])
        return out.cpu().numpy()[:n]

    def _stack(self, requests: Sequence[ScoreRequest]) -> Tuple[np.ndarray, np.ndarray]:
        xs = [np.asarray(r.x, np.float32) for r in requests]
        try:
            X = np.stack(xs)
        except ValueError as e:
            raise ValueError(
                f"request feature shapes do not stack: "
                f"{sorted({x.shape for x in xs})}"
            ) from e
        t = np.asarray([int(r.task) for r in requests], np.int32)
        return X, t

    def _write_back(self, requests: Sequence[ScoreRequest], z: np.ndarray) -> None:
        for r, zi in zip(requests, z):
            r.score = float(zi)
            if self.classify:
                r.label = 1.0 if zi >= 0.0 else -1.0

    def score_batch(self, X, tasks) -> np.ndarray:
        """Array-in/array-out fast path: (n, d) features + (n,) task ids ->
        (n,) margins against the CURRENT snapshot."""
        X, t = self._validate_batch(X, tasks)
        return self._score_tiles(X, t, self.W)

    def run(self, requests: List[ScoreRequest]) -> List[ScoreRequest]:
        """Blocking batch surface: score all requests in fixed-shape tiles
        against the current snapshot; fills score/label in place and
        returns the same list (validation + scoring both delegate to the
        single ``score_batch`` path). Honors ``gather_sigma_rows`` the same
        way the scheduler tile hook does."""
        if not requests:
            return requests
        X, t = self._stack(requests)
        self._write_back(requests, self.score_batch(X, t))
        if self.gather_sigma_rows and self._snapshot.sigma is not None:
            for r, row in zip(requests, self.sigma_rows_for(t)):
                r.sigma_row = row
        return requests

    def sigma_rows_for(self, tasks, sigma=None) -> np.ndarray:
        """Sparse serve-path gather: the (n, m) Sigma rows of ``tasks``
        against ``sigma`` (default: the current snapshot's), in the fixed
        tile shape. Structured snapshots gather straight from the factors
        — the dense (m, m) is never materialized."""
        if sigma is None:
            sigma = self._snapshot.sigma
        if sigma is None:
            raise ValueError(
                "no Sigma on the serving snapshot: build the engine with "
                "sigma=... or publish a snapshot that carries one"
            )
        t = np.ascontiguousarray(np.asarray(tasks, np.int32).reshape(-1))
        if t.size and (t.min() < 0 or t.max() >= self.m):
            raise ValueError(
                f"task id out of range [0, {self.m}): [{t.min()}, {t.max()}]"
            )
        n, B = t.shape[0], self.batch
        pad = (-n) % B
        if pad:
            t = np.concatenate([t, np.zeros((pad,), np.int32)])
        td = torch.from_numpy(t.astype(np.int64)).to(self.device)
        out = torch.empty((t.shape[0], self.m), dtype=torch.float32, device=self.device)
        for lo in range(0, t.shape[0], B):
            out[lo : lo + B] = self._gather(sigma, td[lo : lo + B])
        return out.cpu().numpy()[:n]

    def run_tile(
        self, requests: Sequence[ScoreRequest], snapshot: ModelSnapshot
    ) -> None:
        """Scheduler tile hook: score <= batch requests against the PACKED
        snapshot (not the engine's current one) so in-flight tiles complete
        on the model they were packed with. Requests were already validated
        at admission (``admit``), so the hot path goes straight to the
        shared tile loop. With ``gather_sigma_rows`` on and a Sigma-bearing
        snapshot, each request also gets its task's Sigma row, gathered
        only for the tasks this tile touches."""
        X, t = self._stack(requests)
        self._write_back(requests, self._score_tiles(X, t, snapshot.W))
        if self.gather_sigma_rows and snapshot.sigma is not None:
            rows = self.sigma_rows_for(t, snapshot.sigma)
            for r, row in zip(requests, rows):
                r.sigma_row = row
