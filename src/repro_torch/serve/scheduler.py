"""The versioned model snapshot the serving stack scores against, and the
queue fields every engine's request type shares.

Only ``ModelSnapshot`` and ``ServeRequest`` are here so far: the
continuous-batching scheduler of the JAX package's ``serve`` is a later
part of the port.
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


@dataclasses.dataclass(kw_only=True)
class ServeRequest:
    """Queue fields shared by every engine's request type.

    ``arrival_s``/``deadline_s``/``finish_s`` are absolute times on the
    scheduler's clock; ``deadline_s`` is optional (None = best effort).
    ``status`` walks new -> queued -> done | expired (| shed);
    ``snapshot_version`` records the model version the request was served
    against.
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
