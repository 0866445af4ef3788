"""The comparison that decides ``correct``: the outputs of the window's last
fit against the plain reference's, one number a layer, each beside its
limit (``limits/<cell>.json``).

  alpha   max |alpha - alpha_ref|                    local SDCA round
  W       max |W - W_ref| / max |W_ref|              round + server reduce
  obj     max |D - D_ref|, |P - P_ref| at the tracked rounds, over max |P_ref|
  sigma   max |Sigma - Sigma_ref| / max |Sigma_ref|  Omega-step
  rho     max |rho - rho_ref| / rho_ref              Omega-step's rho
  scores  max |z - z_ref| / max |z_ref|              decision_function on
                                                     the held-out rows
"""
from __future__ import annotations

from typing import Dict

import numpy as np

NAMES = ("alpha", "W", "obj", "sigma", "rho", "scores")


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def numbers(out: Dict[str, np.ndarray], ref) -> Dict[str, float]:
    """The compared numbers. One whose arrays differ in shape, or whose
    program side is not finite, reads infinity."""
    ref_arr = dict(alpha=ref.alpha, W=ref.W, sigma=ref.sigma, rho=np.asarray(ref.rho),
                   scores=ref.scores, dual=np.asarray(ref.dual), primal=np.asarray(ref.primal))

    def sound(*keys):
        return all(np.shape(out[k]) == np.shape(ref_arr[k]) and np.all(np.isfinite(out[k]))
                   for k in keys)

    def rel(k):
        return _rel(out[k], ref_arr[k]) if sound(k) else float("inf")

    obj = float("inf")
    if sound("dual", "primal"):
        scale = max(float(np.max(np.abs(ref_arr["primal"]))), 1e-300)
        obj = max(float(np.max(np.abs(out["dual"] - ref_arr["dual"]))),
                  float(np.max(np.abs(out["primal"] - ref_arr["primal"])))) / scale
    rho = float("inf")
    if sound("rho"):
        rho = float(np.max(np.abs(out["rho"] - ref_arr["rho"]) / ref_arr["rho"]))
    alpha = float(np.max(np.abs(out["alpha"] - ref.alpha))) if sound("alpha") else float("inf")
    return dict(alpha=alpha, W=rel("W"), obj=obj, sigma=rel("sigma"), rho=rho,
                scores=rel("scores"))


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """The numbers the cell's limits name, each with its limit and whether
    it holds."""
    unknown = sorted(set(limits) - set(NAMES))
    if unknown or not limits:
        raise ValueError(f"limits must name some of {NAMES}, got {sorted(limits)}")
    return {k: dict(value=values[k], limit=float(limits[k]), ok=values[k] <= float(limits[k]))
            for k in NAMES if k in limits}
