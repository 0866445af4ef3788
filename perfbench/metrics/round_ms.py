"""round_ms: milliseconds of one communication round (``core/dmtrl.py``
``make_w_step_round``: the local SDCA of every task through
``core/solver_backends.py`` and the server reduce through
``core/sigma_view.py``), called by the harness on the fitted state between
two synchronizes; the mean over the calls of the ``round`` span."""


def read(record):
    span = record.get("spans", {}).get("round")
    if not span or not span["calls"]:
        return None
    return span["seconds"] / span["calls"] * 1e3
