"""DMTRLEstimator — the engine-agnostic training and serving facade.

    est = DMTRLEstimator(loss="hinge", lam=1e-4, rounds=8, solver="pallas_round")
    est.fit(train).score(test)
    z = est.decision_function(x_batch, tasks=task_ids)

  * engines resolve through ``core.engines``: ``reference`` (one process),
    ``distributed`` (the parameter-server W-step over a mesh of process
    groups: ``mesh=``, ``axes=``, ``distributed=DistributedOptions(...)``;
    the local one-device mesh when no mesh is given) or ``async`` (bounded
    staleness over the simulated mesh transport or a host transport, with
    its knobs as ``async_options=AsyncOptions(...)``);
  * the Omega regularizer is a named family member
    (``core.omega_regularizers``) — the paper's trace_constraint by default;
  * ``partial_fit`` warm-starts from the previous (alpha, Sigma) so
    training continues instead of restarting;
  * ``predict``/``decision_function``/``score`` serve the fitted W, and
    ``scoring_engine()`` / ``serving_scheduler()`` / ``serving_fleet()``
    wire it into the batched serving stack (serve/mtl.py,
    serve/scheduler.py, serve/fleet.py); every ``fit``/``partial_fit``
    pushes the new weights into each of them that is still alive.

Everything runs on ``device``: the CUDA card unless the caller passes
``device="cpu"``. Fitted tensors (``W_``, ``alpha_``, ...) stay there,
and so do the serving engines' copies of W.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from . import dual as dual_mod
from .async_dmtrl import AsyncOptions
from .distributed import DistributedOptions, MeshAxes
from .dmtrl import DMTRLConfig, WarmStart, resolve_device
from .engines import Engine, EngineResult, get_engine
from .losses import get_loss
from .mtl_data import MTLData
from .omega_regularizers import OmegaRegularizer, get_regularizer
from .sigma_view import SigmaView

# engine-specific legacy config fields the facade refuses as core params
_ASYNC_FIELDS = frozenset(
    {
        "tau",
        "tau_max",
        "async_delays",
        "omega_delay",
        "transport",
        "n_workers",
        "staleness_budget",
        "topology",
        "codec",
    }
)
_DIST_FIELDS = frozenset({"dist_block_hoisted", "gram_bf16"})
_CONFIG_FIELDS = frozenset(f.name for f in dataclasses.fields(DMTRLConfig))

# history keys that index time and must continue, not restart, across
# partial_fit calls (value added to the new segment = last max seen)
_TIME_KEYS = ("round", "tick", "w_tick", "gate_refusals")
# 0-based counters: continue at prev_max + 1
_COUNTER_KEYS = ("outer", "w_round", "min_round")


class NotFittedError(RuntimeError):
    pass


class DMTRLEstimator:
    """Engine-agnostic DMTRL estimator with an sklearn-flavoured surface.

    Parameters
    ----------
    engine : "reference" | "distributed" | "async" (core.engines registry)
    config : optional pre-built core DMTRLConfig; core field kwargs
        (``loss=``, ``lam=``, ``rounds=`` ...) override it. Engine-specific
        legacy fields (``tau``, ``dist_block_hoisted``, ...) are rejected
        here — pass ``async_options=AsyncOptions(...)`` /
        ``distributed=DistributedOptions(...)`` instead.
    mesh / axes : mesh engines only (``distributed.make_mesh``); the local
        one-device mesh on ``device`` is used when omitted. A mesh's device
        must be of ``device``'s type (the engine checks at fit).
    distributed : the mesh engine's DistributedOptions (axes, the Gram
        options of a model axis); the async engine merges its Gram options
        into the config.
    async_options : the async engine's AsyncOptions (transport, workers,
        tau, codec, ...).
    regularizer : Omega family member name or OmegaRegularizer instance
        (core.omega_regularizers); ``regularizer_params`` configure named
        members.
    device : where training and scoring run; "cuda" (the default) raises
        when no card is present.

    Fitted attributes (trailing underscore): ``W_``, ``alpha_``,
    ``sigma_``, ``omega_``, ``history_``, ``rho_per_outer_``;
    structured regularizers additionally set ``sigma_view_`` (the
    SigmaView factors; ``sigma_`` stays the view itself at huge m instead
    of a dense (m, m), ``omega_`` may be None).
    """

    def __init__(
        self,
        engine: str = "reference",
        *,
        config: Optional[DMTRLConfig] = None,
        mesh=None,
        axes: Optional[MeshAxes] = None,
        distributed: Optional[DistributedOptions] = None,
        regularizer: Union[str, OmegaRegularizer, None] = None,
        regularizer_params: Optional[dict] = None,
        async_options: Optional[AsyncOptions] = None,
        device="cuda",
        **params,
    ):
        self.engine: Engine = get_engine(engine)
        self.device = resolve_device(device)

        leaked = sorted((_ASYNC_FIELDS | _DIST_FIELDS) & params.keys())
        if leaked:
            raise ValueError(
                f"{leaked} are per-engine options, not core config fields; "
                "pass async_options=AsyncOptions(...) / "
                "distributed=DistributedOptions(...) instead"
            )
        if async_options is not None and self.engine.name != "async":
            raise ValueError(
                f'AsyncOptions need engine="async", got engine='
                f"{self.engine.name!r}"
            )
        if self.engine.name == "reference":
            if mesh is not None or axes is not None:
                raise ValueError(
                    'engine="reference" is single-process; mesh/axes need '
                    'engine="distributed" or "async"'
                )
            if distributed is not None or async_options is not None:
                raise ValueError(
                    'engine="reference" takes no DistributedOptions/'
                    "AsyncOptions — the facade keeps per-engine knobs out "
                    "of the reference path"
                )
        if distributed is not None and not isinstance(distributed, DistributedOptions):
            raise TypeError(
                f"distributed= takes DistributedOptions, got "
                f"{type(distributed).__name__}"
            )
        if async_options is not None and not isinstance(async_options, AsyncOptions):
            raise TypeError(
                f"async_options= takes AsyncOptions, got "
                f"{type(async_options).__name__}"
            )
        self.mesh = mesh
        self.axes = axes
        self.distributed_options = distributed
        self.async_options = async_options
        unknown = sorted(params.keys() - _CONFIG_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown config fields {unknown}; valid core fields: "
                f"{sorted(_CONFIG_FIELDS - _ASYNC_FIELDS - _DIST_FIELDS)}"
            )
        cfg = config if config is not None else DMTRLConfig()
        if params:
            cfg = dataclasses.replace(cfg, **params)
        self.config: DMTRLConfig = cfg

        if regularizer is None:
            # legacy learn_omega=False maps to the identity_stl member
            regularizer = cfg.omega_regularizer if cfg.learn_omega else "identity_stl"
        if isinstance(regularizer, str):
            regularizer = get_regularizer(regularizer, **(regularizer_params or {}))
        elif regularizer_params:
            raise ValueError("regularizer_params only apply when regularizer is a name")
        self.regularizer: OmegaRegularizer = regularizer
        self._loss = get_loss(cfg.loss)
        self._fitted = False
        self.sigma_view_: Optional[SigmaView] = None
        self.history_: Dict[str, np.ndarray] = {}
        self.rho_per_outer_: list = []
        self.n_fit_calls_: int = 0
        # serving surface: model version bumps on every install, and every
        # engine/scheduler/router built from this estimator gets the new
        # snapshot pushed (weak refs: serving objects own their lifetime)
        self._model_version: int = 0
        self._model_refs: list = []

    # -- training -----------------------------------------------------------
    def _engine_kwargs(self) -> dict:
        if self.engine.name == "reference":
            return dict(cfg=self.config)
        options = None
        if self.engine.options_cls is AsyncOptions:
            options = self.async_options
        elif self.engine.options_cls is DistributedOptions:
            options = self.distributed_options
        cfg = self.config
        if self.engine.name == "async" and self.distributed_options is not None:
            # async runs the distributed round's pieces; its Gram knobs
            # ride in through the merged config
            cfg = self.distributed_options.merge_into(cfg)
        axes = self.axes
        if axes is None and self.distributed_options is not None:
            axes = self.distributed_options.axes
        return dict(cfg=cfg, mesh=self.mesh, axes=axes, options=options)

    def _run(self, data: MTLData, init: Optional[WarmStart], track: bool):
        kw = self._engine_kwargs()
        cfg = kw.pop("cfg")
        res: EngineResult = self.engine.run(
            cfg, data, regularizer=self.regularizer, init=init,
            track=track, device=self.device, **kw,
        )
        self._install(res, continued=init is not None)
        return res

    def _install(self, res: EngineResult, continued: bool) -> None:
        self.W_ = res.W
        self.alpha_ = res.alpha
        self.sigma_ = res.sigma
        self.omega_ = res.omega
        self.sigma_view_ = res.sigma_view
        if continued and self.history_:
            self.history_ = _merge_histories(self.history_, res.history)
        else:
            self.history_ = dict(res.history)
        if res.rho_per_outer is not None:
            if continued:
                self.rho_per_outer_.extend(res.rho_per_outer)
            else:
                self.rho_per_outer_ = list(res.rho_per_outer)
        self._fitted = True
        self.n_fit_calls_ += 1
        self._model_version += 1
        self._publish_model()

    def fit(self, data: MTLData, track: bool = True) -> "DMTRLEstimator":
        """Run the full alternating procedure from scratch. Returns self."""
        self.n_fit_calls_ = 0
        self._run(data, init=None, track=track)
        return self

    def partial_fit(self, data: MTLData, track: bool = True) -> "DMTRLEstimator":
        """Continue training from the current (alpha, Sigma) state.

        The first call behaves like ``fit``; later calls warm-start from the
        previous dual variables and task covariance (W is rederived as
        W(alpha)), appending to ``history_``.
        """
        init = None
        if self._fitted:
            # structured fits warm-start from the factors, never a dense
            # (m, m); dense fits keep the tensor path
            sigma = self.sigma_view_ if self.sigma_view_ is not None else self.sigma_
            init = WarmStart(alpha=self.alpha_, sigma=sigma, omega=self.omega_)
        self._run(data, init=init, track=track)
        return self

    # -- inference ----------------------------------------------------------
    def _check_fitted(self) -> None:
        if not self._fitted:
            raise NotFittedError(
                "this DMTRLEstimator is not fitted yet; call fit(data) first"
            )

    def decision_function(
        self,
        X: Union[MTLData, np.ndarray, torch.Tensor],
        tasks: Union[int, Sequence[int], None] = None,
    ) -> torch.Tensor:
        """Raw scores z = w_task^T x, on the estimator's device.

        ``X`` may be an MTLData (returns the (m, n_max) masked score matrix)
        or an (n, d) / (d,) array or tensor with ``tasks`` a scalar or (n,)
        task ids.
        """
        self._check_fitted()
        W = self.W_
        if isinstance(X, MTLData):
            if tasks is not None:
                raise ValueError(
                    "tasks= only applies to array inputs; an MTLData is "
                    "scored per task already (rows of the returned matrix)"
                )
            X = X.to(self.device)
            return dual_mod.predictions(X, W) * X.mask
        X = torch.atleast_2d(torch.as_tensor(X, dtype=W.dtype, device=self.device))
        if X.shape[-1] != W.shape[1]:
            raise ValueError(
                f"X has {X.shape[-1]} features, the fitted W has {W.shape[1]}"
            )
        if tasks is None:
            raise ValueError("array inputs need tasks= (scalar task id or one per row)")
        t = np.array(np.broadcast_to(np.asarray(tasks, np.int64), (X.shape[0],)))
        if t.size and (t.min() < 0 or t.max() >= W.shape[0]):
            raise ValueError(
                f"task ids must be in [0, {W.shape[0]}), got [{t.min()}, {t.max()}]"
            )
        return dual_mod.task_scores(W, X, torch.as_tensor(t, device=self.device))

    def predict(
        self,
        X: Union[MTLData, np.ndarray, torch.Tensor],
        tasks: Union[int, Sequence[int], None] = None,
    ) -> torch.Tensor:
        """Class labels (+-1) for classification losses, raw scores for
        regression losses."""
        z = self.decision_function(X, tasks)
        if self._loss.is_classification:
            return torch.where(z >= 0.0, 1.0, -1.0).to(z.dtype)
        return z

    def score(self, data: MTLData) -> float:
        """Masked mean-per-task accuracy for classification losses,
        explained variance for regression losses (paper's School metric)."""
        self._check_fitted()
        data = data.to(self.device)
        if self._loss.is_classification:
            return 1.0 - float(dual_mod.error_rate(data, self.W_))
        return float(dual_mod.explained_variance(data, self.W_))

    @property
    def history(self) -> Dict[str, np.ndarray]:
        """Objective traces accumulated over fit/partial_fit."""
        self._check_fitted()
        return self.history_

    # -- serving ------------------------------------------------------------
    def model_snapshot(self):
        """The current servable model as a versioned ModelSnapshot
        (W, Sigma, version). The version bumps on every ``fit`` /
        ``partial_fit`` install."""
        self._check_fitted()
        from ..serve.scheduler import ModelSnapshot

        sigma = self.sigma_view_ if self.sigma_view_ is not None else self.sigma_
        return ModelSnapshot(version=self._model_version, W=self.W_, sigma=sigma)

    def _publish_model(self) -> None:
        """Push the new snapshot to every live serving object built from
        this estimator (hot-swap: engines/schedulers switch weights
        without draining; in-flight tiles finish on the old snapshot).
        Uses the restamping ``publish_weights`` surface so a consumer
        whose version counter ran ahead (a manual ``swap``) still installs
        the newly trained weights instead of colliding."""
        targets = [obj for obj in (r() for r in self._model_refs) if obj is not None]
        self._model_refs = [weakref.ref(obj) for obj in targets]
        if not targets:
            return
        snap = self.model_snapshot()
        for obj in targets:
            obj.publish_weights(snap.W, snap.sigma, snap.version)

    def _engine(self, batch: int, **kwargs):
        from ..serve.mtl import MTLScoringEngine

        snap = self.model_snapshot()
        return MTLScoringEngine(
            snap.W,
            batch=batch,
            classify=self._loss.is_classification,
            version=snap.version,
            sigma=snap.sigma,
            device=self.device,
            **kwargs,
        )

    def scoring_engine(self, batch: int = 32, *, gather_sigma_rows: bool = False):
        """Batched MTL scoring engine over the fitted W (serve/mtl.py), on
        the estimator's device.

        The engine is version-bound and SUBSCRIBED: a later
        ``partial_fit`` pushes the new weights into it (and ``refresh()``
        pulls them), so it never silently serves stale weights. The
        fitted Sigma (structured factors when available) rides on the
        snapshot; ``gather_sigma_rows=True`` makes every served tile
        attach each request's task-relatedness row.
        """
        self._check_fitted()
        engine = self._engine(batch, source=self, gather_sigma_rows=gather_sigma_rows)
        self._model_refs.append(weakref.ref(engine))
        return engine

    def serving_scheduler(
        self,
        batch: int = 32,
        *,
        slo_s: Optional[float] = None,
        policy: str = "edf",
        max_queue: Optional[int] = None,
        clock=None,
        metrics=None,
    ):
        """Continuous-batching scheduler over a fresh scoring engine
        (serve/scheduler.py), subscribed to this estimator's snapshots:
        ``partial_fit`` hot-swaps the served weights between tiles."""
        from ..serve.scheduler import ContinuousBatchingScheduler

        engine = self.scoring_engine(batch=batch)
        kwargs = dict(slo_s=slo_s, policy=policy, max_queue=max_queue, metrics=metrics)
        if clock is not None:
            kwargs["clock"] = clock
        scheduler = ContinuousBatchingScheduler(engine, **kwargs)
        self._model_refs.append(weakref.ref(scheduler))
        return scheduler

    def serving_fleet(
        self,
        n_replicas: int = 2,
        batch: int = 32,
        *,
        slo_s: Optional[float] = None,
        policy: str = "edf",
        max_queue: Optional[int] = None,
        clock=None,
        tile_cost_s: Optional[float] = None,
        spill_depth: Optional[int] = None,
    ):
        """A ``FleetRouter`` over ``n_replicas`` fresh scheduler replicas
        (serve/fleet.py), each wrapping its own scoring engine over the
        fitted model on the estimator's device.

        Only the ROUTER subscribes to this estimator: a later
        ``partial_fit`` pushes new weights through the router's rolling
        ``publish_weights`` (one replica per router step, monotonic reads
        preserved), never to replicas individually — direct per-replica
        pushes would restamp versions divergently and break the fleet's
        shared version space. ``slo_s`` doubles as the router's shed
        budget for deadline-less requests; give ``tile_cost_s`` to enable
        backlog-estimate shedding.
        """
        self._check_fitted()
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        from ..serve.fleet import FleetRouter
        from ..serve.scheduler import ContinuousBatchingScheduler

        kwargs = dict(slo_s=slo_s, policy=policy, max_queue=max_queue)
        if clock is not None:
            kwargs["clock"] = clock
        replicas = [
            ContinuousBatchingScheduler(self._engine(batch), **kwargs)
            for _ in range(n_replicas)
        ]
        router = FleetRouter(
            replicas, slo_s=slo_s, tile_cost_s=tile_cost_s, spill_depth=spill_depth
        )
        self._model_refs.append(weakref.ref(router))
        return router

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        state = "fitted" if self._fitted else "unfitted"
        return (
            f"DMTRLEstimator(engine={self.engine.name!r}, "
            f"loss={self.config.loss!r}, "
            f"regularizer={self.regularizer.name!r}, device={str(self.device)!r}, "
            f"{state})"
        )


def _merge_histories(
    old: Dict[str, np.ndarray], new: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Append a continuation run's history: time-like keys are offset so
    they continue where the previous run stopped, the rest concatenate."""
    merged: Dict[str, np.ndarray] = {}
    for k in new.keys() | old.keys():
        if k not in old:
            merged[k] = np.asarray(new[k])
            continue
        if k not in new:
            merged[k] = np.asarray(old[k])
            continue
        o, n = np.asarray(old[k]), np.asarray(new[k])
        if o.shape[1:] != n.shape[1:]:
            raise ValueError(
                f"history key {k!r} changed shape across partial_fit calls: "
                f"{o.shape} vs {n.shape}"
            )
        if o.size and n.size and o.ndim == 1 and (k in _TIME_KEYS or k in _COUNTER_KEYS):
            n = n + o.max() + (1 if k in _COUNTER_KEYS else 0)
        merged[k] = np.concatenate([o, n], axis=0)
    return merged
