"""Faults planted in the program's timed path, each of which the comparison
has to catch (``correct`` false):

  unchanged       every communication round returns its state unchanged
  half_the_tasks  every round leaves the second half of the tasks as they
                  were and updates the rest
  answer_altered  ``decision_function`` moves one held-out score by 1 % of
                  the largest, where the answer is produced

``planted(name)`` puts one in place for the duration of a ``with`` block.
The harness's tests run them on the CPU at a small size, and
``control.py --faults`` reads them on the card at each cell's size.
"""
from __future__ import annotations

import contextlib

NAMES = ("unchanged", "half_the_tasks", "answer_altered")


def _broken_round(make, how: str):
    def broken(cfg, data, rho):
        round_fn = make(cfg, data, rho)

        def fn(alpha, W, sigma, key):
            a, w = round_fn(alpha, W, sigma, key)
            if how == "unchanged":
                return alpha, W
            half = alpha.shape[0] // 2
            a[half:], w[half:] = alpha[half:], W[half:]
            return a, w

        return fn

    return broken


def _altered(real):
    def decision_function(self, X, tasks=None):
        z = real(self, X, tasks)
        z[0, 0] += 0.01 * float(z.abs().max())
        return z

    return decision_function


@contextlib.contextmanager
def planted(name: str):
    """The program with the fault ``name`` in its timed path."""
    if name == "answer_altered":
        from repro_torch.core.estimator import DMTRLEstimator as owner

        attr = "decision_function"
        patched = _altered(owner.decision_function)
    elif name in ("unchanged", "half_the_tasks"):
        from repro_torch.core import dmtrl as owner

        attr = "make_w_step_round"
        patched = _broken_round(owner.make_w_step_round, name)
    else:
        raise ValueError(f"no fault {name!r}; have {NAMES}")
    real = owner.__dict__[attr]
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, real)
