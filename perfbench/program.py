"""The system under test: ``repro_torch.core.DMTRLEstimator.fit`` on the
arrays the harness made, and the calls into its layers that the traced run
times (one communication round, one Omega-step).

Nothing here imports the program at module level: the harness sets the
cache directories first, and the tests import this module on the CPU.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np


class Program:
    """One estimator over one cell's data, fitted again and again."""

    def __init__(self, arrays, config: Dict, traffic: Dict, seed: int, device):
        import torch
        from repro_torch.core import DMTRLEstimator
        from repro_torch.core.mtl_data import from_task_list

        self.torch = torch
        self.device = torch.device(device)
        self.traffic = traffic
        self.train = from_task_list(arrays.xtr, arrays.ytr, device=self.device)
        self.test = from_task_list(arrays.xte, arrays.yte, device=self.device)
        om = traffic["omega"]
        self.est = DMTRLEstimator(
            engine=traffic["engine"], device=self.device,
            regularizer=om["member"], regularizer_params=om.get("params") or None,
            loss=traffic["loss"], lam=float(config["lam"]), solver=traffic["solver"],
            outer_iters=int(traffic["outer_iters"]), rounds=int(traffic["rounds"]),
            local_iters=int(traffic["local_iters"]), block_size=int(traffic["block_size"]),
            track_every=int(traffic["track_every"]), seed=seed,
        )

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def fit(self) -> None:
        """One job: a whole fit from scratch, finished on the device."""
        self.est.fit(self.train)
        self.sync()

    def shapes(self) -> Dict:
        """The sizes the per-layer formulas read."""
        t = self.traffic
        m, n_max, d = self.train.m, self.train.n_max, self.train.d
        B = int(t["block_size"])
        H = int(t["local_iters"]) or n_max
        H = int(math.ceil(H / B)) * B
        return dict(
            m=m, n_max=n_max, d=d, B=B, H=H, n_total=int(self.train.n.sum()),
            outer_iters=int(t["outer_iters"]), rounds=int(t["rounds"]),
            member=t["omega"]["member"], tracked=int(len(self.est.history_.get("dual", []))),
        )

    def outputs(self) -> Dict[str, np.ndarray]:
        """What the last fit produced, on the host in float64: the fitted
        W, alpha and Sigma, rho per outer iteration, the tracked objectives
        and the held-out rows' scores through ``decision_function``."""
        est = self.est
        sig = est.sigma_
        sig = sig.dense() if hasattr(sig, "dense") else sig

        def host(t):
            return t.detach().double().cpu().numpy()

        return dict(
            W=host(est.W_), alpha=host(est.alpha_), sigma=host(sig),
            rho=np.asarray(est.rho_per_outer_, np.float64),
            dual=np.asarray(est.history_["dual"], np.float64),
            primal=np.asarray(est.history_["primal"], np.float64),
            scores=host(est.decision_function(self.test)),
        )

    # -- the layers the traced run times ---------------------------------
    def _timed(self, call, min_seconds: float, min_calls: int) -> Dict:
        """``call`` repeated over at least ``min_seconds`` and ``min_calls``
        after one untimed call, the device synchronized at both ends."""
        call()
        self.sync()
        calls, t0 = 0, time.perf_counter()
        while calls < min_calls or time.perf_counter() - t0 < min_seconds:
            call()
            calls += 1
            self.sync()
        return dict(calls=calls, seconds=time.perf_counter() - t0)

    def time_round(self, min_seconds: float = 0.5) -> Dict:
        """One communication round (local SDCA through the solver backend,
        the reduce through the Sigma view) on the fitted state."""
        from repro_torch import prng
        from repro_torch.core.dmtrl import make_w_step_round

        est = self.est
        sigma = est.sigma_view_ if est.sigma_view_ is not None else est.sigma_
        round_fn = make_w_step_round(est.config, self.train, est.rho_per_outer_[-1])
        key = prng.PRNGKey(est.config.seed)
        alpha, W = est.alpha_, est.W_
        return self._timed(lambda: round_fn(alpha, W, sigma, key), min_seconds, 3)

    def time_omega(self, min_seconds: float = 0.5) -> Dict:
        """The configured Omega-step on the fitted W."""
        from repro_torch.core.omega_regularizers import get_regularizer

        om = self.traffic["omega"]
        reg = get_regularizer(om["member"], **(om.get("params") or {}))
        W, jitter = self.est.W_, self.est.config.omega_jitter
        return self._timed(lambda: reg.step(W, jitter), min_seconds, 2)

    def close(self) -> None:
        """Drop the program's state so the reference finds the card empty."""
        self.est = self.train = self.test = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
