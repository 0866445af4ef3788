"""Carry a fitted model across from the JAX package.

The JAX estimator's fitted state is a handful of numpy arrays; this module
turns it into a fitted port estimator, so ``partial_fit`` continues and
``predict`` serves from exactly that state on the card:

    state = {k: getattr(jax_est, k) for k in STATE_KEYS}
    est = from_reference(state, device="cuda", config=cfg)
    est.partial_fit(train)          # train: the port's MTLData of the same arrays

A problem goes across the same way: build the port's ``MTLData`` from the
same numpy arrays (``core.mtl_data.from_task_list`` or
``data.synthetic``, which match the JAX package's seed for seed).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .core.engines import EngineResult
from .core.estimator import DMTRLEstimator

# the JAX estimator's fitted attributes that make up its state
STATE_KEYS = ("W_", "alpha_", "sigma_", "omega_", "rho_per_outer_", "history_")


def from_reference(
    state: Mapping[str, object], device="cuda", **estimator_kwargs
) -> DMTRLEstimator:
    """A fitted ``DMTRLEstimator`` holding ``state`` (numpy arrays under
    the names in ``STATE_KEYS``; ``omega_``, ``rho_per_outer_`` and
    ``history_`` may be missing). ``estimator_kwargs`` (``config=``,
    ``loss=``, ...) configure it as the JAX estimator was configured."""
    est = DMTRLEstimator(device=device, **estimator_kwargs)

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32, device=est.device)

    omega = state.get("omega_")
    history: Dict[str, np.ndarray] = {
        k: np.asarray(v) for k, v in (state.get("history_") or {}).items()
    }
    est._install(
        EngineResult(
            W=tensor(state["W_"]),
            alpha=tensor(state["alpha_"]),
            sigma=tensor(state["sigma_"]),
            omega=None if omega is None else tensor(omega),
            history=history,
            rho_per_outer=[float(r) for r in state.get("rho_per_outer_") or []],
        ),
        continued=False,
    )
    return est


def lm_params_from_reference(cfg, params_np: Mapping, device="cuda") -> Dict:
    """The port's LM param dict from the JAX package's ``init_params`` pytree
    with its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``):
    the same keys and stacked layer axes, each leaf a tensor of the same
    dtype on ``device``. ``cfg`` names the architecture the pytree is for."""
    from .core.dmtrl import resolve_device
    from .models.transformer import _require_hybrid

    _require_hybrid(cfg)
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no numpy twin in torch
            return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    def tree(node):
        if isinstance(node, Mapping):
            return {k: tree(v) for k, v in node.items()}
        return leaf(node)

    return tree(params_np)
