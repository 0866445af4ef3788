"""omega_ms: milliseconds of one Omega-step (``core/omega.py``,
``core/omega_regularizers.py``): ``get_regularizer(<member>, **params)
.step(W, jitter)`` on the fitted W, called by the harness between two
synchronizes; the mean over the calls of the ``omega_step`` span."""


def read(record):
    span = record.get("spans", {}).get("omega_step")
    if not span or not span["calls"]:
        return None
    return span["seconds"] / span["calls"] * 1e3
