"""The versioned model snapshot the serving stack scores against.

Only ``ModelSnapshot`` is here so far: the continuous-batching scheduler
and the scoring engine of the JAX package's ``serve`` are a later part of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """An immutable versioned model: what one tile is scored against.

    For the MTL scorer ``W`` (m, d) is the task-weight matrix and ``sigma``
    the task covariance that produced it. Versions are strictly
    increasing: every estimator install stamps a new one.
    """

    version: int
    W: Optional[Any] = None
    sigma: Optional[Any] = None
