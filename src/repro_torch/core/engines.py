"""Training-engine registry: one facade contract over the drivers.

The estimator resolves an engine with ``get_engine`` and calls the uniform

    engine.run(cfg, data, regularizer=..., init=..., track=..., device=...)
        -> EngineResult

contract. Registered here:

  reference    single-process Algorithm 1 (core/dmtrl.py:fit); the
               semantic oracle.

The JAX package's ``distributed`` and ``async`` engines are not ported
yet; asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .dmtrl import DMTRLConfig, WarmStart, fit as _fit_reference
from .mtl_data import MTLData
from .sigma_view import SigmaView

_NOT_PORTED = ("distributed", "async")


@dataclasses.dataclass
class EngineResult:
    """Engine-agnostic fit result, at the raw problem size, on the run's
    device — what the estimator stores."""

    W: torch.Tensor  # (m, d) task weight rows
    alpha: torch.Tensor  # (m, n_max) dual variables
    sigma: torch.Tensor  # (m, m) task covariance
    omega: Optional[torch.Tensor]  # (m, m) task precision, or None
    history: Dict[str, np.ndarray]
    rho_per_outer: Optional[List[float]] = None
    sigma_view: Optional[SigmaView] = None


@dataclasses.dataclass(frozen=True)
class Engine:
    """A named way to run Algorithm 1 end to end."""

    name: str
    description: str
    # run(cfg, data, *, regularizer, init, track, device)
    run: Callable[..., EngineResult]


_REGISTRY: Dict[str, Engine] = {}


def register_engine(engine: Engine) -> Engine:
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str) -> Engine:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet; have {sorted(_REGISTRY)}"
        )
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown engine {name!r}; have {sorted(_REGISTRY)}") from e


def available_engines() -> Dict[str, Engine]:
    return dict(sorted(_REGISTRY.items()))


def _run_reference(
    cfg: DMTRLConfig,
    data: MTLData,
    *,
    regularizer=None,
    init: Optional[WarmStart] = None,
    track: bool = True,
    device="cuda",
) -> EngineResult:
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
