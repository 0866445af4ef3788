"""Serving: continuous-batching scheduler over batched LM and MTL engines.

The JAX package's exports (but ``make_serve_step``: the LM engine here
runs eagerly). Submodules load lazily (PEP 562): the MTL scoring surface
must not pull in the LM model stack that ``engine`` imports (models,
flash and SSD kernels), and vice versa. ``scheduler``/``metrics`` are
engine-agnostic (no model imports at all).
"""
_LM = {"Request", "ServeConfig", "ServingEngine"}
_MTL = {"MTLScoringEngine", "ScoreRequest", "make_score_step"}
_SCHED = {
    "ContinuousBatchingScheduler",
    "ModelSnapshot",
    "QueueFull",
    "ServeRequest",
    "SubmitOutcome",
    "VirtualClock",
}
_METRICS = {"LatencyHistogram", "ServingMetrics"}
_FLEET = {"ClientToken", "FleetRouter", "ReplicaHandle"}

__all__ = sorted(_LM | _MTL | _SCHED | _METRICS | _FLEET)


def __getattr__(name):
    if name in _LM:
        from . import engine

        return getattr(engine, name)
    if name in _MTL:
        from . import mtl

        return getattr(mtl, name)
    if name in _SCHED:
        from . import scheduler

        return getattr(scheduler, name)
    if name in _METRICS:
        from . import metrics

        return getattr(metrics, name)
    if name in _FLEET:
        from . import fleet

        return getattr(fleet, name)
    raise AttributeError(f"module 'repro_torch.serve' has no attribute {name!r}")
