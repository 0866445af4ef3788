"""Training-engine registry: one facade contract over the drivers.

The estimator resolves an engine with ``get_engine`` and calls the uniform

    engine.run(cfg, data, mesh=..., axes=..., options=..., regularizer=...,
               init=..., track=..., device=...) -> EngineResult

contract. Registered here:

  reference    single-process Algorithm 1 (core/dmtrl.py:fit); the
               semantic oracle. No mesh, no options.
  distributed  the parameter-server W-step over a mesh of process groups
               (core/distributed.py:fit_distributed); DistributedOptions.
  async        bounded-staleness (SSP) engine (core/async_dmtrl.py:
               fit_async) over the simulated mesh transport or a host
               transport (threaded, multiprocess, gossip); AsyncOptions.

The mesh engines run on the local one-device mesh on ``device`` when the
caller passes no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .async_dmtrl import AsyncOptions, fit_async as _fit_async
from .distributed import (
    DistributedOptions,
    MeshAxes,
    fit_distributed as _fit_distributed,
    gather_state,
    local_mesh,
)
from .dmtrl import DMTRLConfig, WarmStart, fit as _fit_reference
from .mtl_data import MTLData
from .sigma_view import SigmaView, maybe_dense
from ..obs.trace import span


@dataclasses.dataclass
class EngineResult:
    """Engine-agnostic fit result, at the raw problem size, on the run's
    device — what the estimator stores."""

    W: torch.Tensor  # (m, d) task weight rows
    alpha: torch.Tensor  # (m, n_max) dual variables
    sigma: torch.Tensor  # (m, m) task covariance; a SigmaView at huge m
    omega: Optional[torch.Tensor]  # (m, m) task precision; None when the
    #               structured member has no cheap inverse at this size
    history: Dict[str, np.ndarray]
    rho_per_outer: Optional[List[float]] = None
    # structured runs also expose the factors (SigmaView) directly
    sigma_view: Optional[SigmaView] = None


@dataclasses.dataclass(frozen=True)
class Engine:
    """A named way to run Algorithm 1 end to end."""

    name: str
    description: str
    # run(cfg, data, *, mesh, axes, options, regularizer, init, track, device)
    run: Callable[..., EngineResult]
    # the typed options its run takes as options= (None: takes none)
    options_cls: Optional[type] = None


_REGISTRY: Dict[str, Engine] = {}


def register_engine(engine: Engine) -> Engine:
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str) -> Engine:
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown engine {name!r}; have {sorted(_REGISTRY)}") from e


def available_engines() -> Dict[str, Engine]:
    return dict(sorted(_REGISTRY.items()))


def _unpad_state(state, raw: MTLData) -> tuple:
    """(alpha, omega) rows/cols of the REAL tasks from whole padded state."""
    alpha = state.alpha[: raw.m, : raw.n_max]
    if state.omega is None:
        omega = None
    elif isinstance(state.omega, SigmaView):
        omega = maybe_dense(state.omega.unpad(raw.m))
    else:
        omega = state.omega[: raw.m, : raw.m]
    return alpha, omega


def _run_reference(
    cfg: DMTRLConfig,
    data: MTLData,
    *,
    mesh=None,
    axes: Optional[MeshAxes] = None,
    options=None,
    regularizer=None,
    init: Optional[WarmStart] = None,
    track: bool = True,
    device="cuda",
) -> EngineResult:
    if mesh is not None or axes is not None or options is not None:
        raise ValueError(
            "the reference engine runs single-process: mesh/axes/options "
            'are distributed-only (use engine="distributed" or "async")'
        )
    with span("engine_run", cat="driver", engine="reference"):
        res = _fit_reference(
            cfg, data, track=track, init=init, regularizer=regularizer, device=device
        )
    return EngineResult(
        W=res.W,
        alpha=res.alpha,
        sigma=res.sigma,
        omega=res.omega,
        history=res.history,
        rho_per_outer=list(res.rho_per_outer),
        sigma_view=res.sigma_view,
    )


register_engine(
    Engine(
        name="reference",
        description="single-process Algorithm 1 (all tasks batched); the "
        "semantic oracle",
        run=_run_reference,
    )
)


def _make_mesh_run(engine_name: str) -> Callable[..., EngineResult]:
    """One adapter for both mesh engines: resolve a default mesh, forward
    to the fit function (which resolves the axes itself), unpad, pack
    EngineResult."""

    def run(
        cfg: DMTRLConfig,
        data: MTLData,
        *,
        mesh=None,
        axes: Optional[MeshAxes] = None,
        options=None,
        regularizer=None,
        init: Optional[WarmStart] = None,
        track: bool = True,
        device="cuda",
    ) -> EngineResult:
        ax = axes or getattr(options, "axes", None) or MeshAxes()
        if mesh is None:  # the one-device mesh, so no ceremony is needed
            mesh = local_mesh(ax, device)
        elif torch.device(device).type != mesh.device.type:
            raise ValueError(f"the mesh is on {mesh.device}, the run asks for {device!r}")
        with span("engine_run", cat="driver", engine=engine_name):
            if engine_name == "distributed":
                W, sigma, state, hist = _fit_distributed(
                    cfg, data, mesh, axes, track=track, options=options, init=init,
                    regularizer=regularizer,
                )
                # every rank's blocks -> the whole padded state
                state = gather_state(state, mesh, ax)
            else:
                W, sigma, state, hist = _fit_async(
                    cfg, data, mesh, axes, track=track, options=options, init=init,
                    regularizer=regularizer, device=device,
                )
        alpha, omega = _unpad_state(state, data)
        sigma_view = None
        if isinstance(state.sigma, SigmaView):
            sigma_view = state.sigma.unpad(data.m)
        return EngineResult(
            W=W, alpha=alpha, sigma=maybe_dense(sigma), omega=omega, history=hist,
            sigma_view=sigma_view,
        )

    return run


register_engine(
    Engine(
        name="distributed",
        description="parameter-server W-step over a mesh of process groups "
        "(data/model/pod axes); bulk-synchronous rounds",
        run=_make_mesh_run("distributed"),
        options_cls=DistributedOptions,
    )
)
register_engine(
    Engine(
        name="async",
        description="bounded-staleness (SSP) engine: workers commit against "
        "snapshots at most tau rounds stale over a pluggable transport "
        "(simulated/threaded/multiprocess/gossip); tau=0 == distributed",
        run=_make_mesh_run("async"),
        options_cls=AsyncOptions,
    )
)
