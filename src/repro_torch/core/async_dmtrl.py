"""Asynchronous bounded-staleness DMTRL engine — a thin protocol driver.

The paper's Algorithm 1 is bulk-synchronous: every communication round
barriers on all the workers' delta_b before the server reduce, so one
straggler stalls all m tasks. Baytas et al. (arXiv:1609.09563) and Wang et
al. (arXiv:1802.03830) show the same primal-dual MTL structure tolerates
*bounded staleness* in the worker->server updates. The portable object is
the PROTOCOL — snapshot -> local solve -> SSP-gated commit — not the
execution substrate, so this module is only the outer alternation:

    for p in outer_iters:
        rho  <- regularizer rho bound on the (possibly pending) Sigma
        transport.run_w_step(p, rho, outer_key)      # R protocol rounds
        Sigma, Omega <- regularizer.step(W)          # Omega-step
        transport.install_sigma(...)                 # maybe overlapped

over a pluggable ``core.transport`` member (``AsyncOptions.transport``):

  threaded      real in-host parameter server (G worker threads, lock-
                protected versioned state, nondeterministic arrivals).
  multiprocess  socket/pickle parameter server with per-worker processes.
  gossip        serverless neighbor averaging (core/gossip.py).
  simulated     deterministic per-worker clocks over a mesh (the data
                axis's positions are the workers), one masked SPMD tick per
                commit event (the default; without a mesh, the local
                one-device mesh on ``device``).

Staleness semantics (all transports)
------------------------------------
A contribution's *staleness* is the number of server commit events between
its snapshot and its application; its *lag* is how many rounds ahead of the
slowest worker it ran. The SSP gate admits a worker to round r only while
``r <= min_completed + tau`` (``tau=0`` degenerates to the bulk-synchronous
barrier). Every applied contribution flows through one accounting path —
``transport.CommitReceipt -> record_receipt -> history`` — summarized by
``convergence.staleness_summary`` / ``convergence.effective_gap_curve``.

``tau="auto"`` turns the static bound into a small online controller
(``transport._adapt_tau``); the bound in effect at every commit is recorded
in ``history["tau_trace"]``.

The Omega-step overlaps with in-flight W-rounds instead of barriering:
with ``omega_delay = k > 0`` the Sigma/Omega computed at a W-step boundary
is *installed* only after k server commits of the next W-step. rho is still
computed from the new Sigma at the boundary. A pending Sigma is never
dropped — it lands at the next barrier at the latest.

Parity anchors: at ``tau=0`` the ``simulated`` transport runs
``fit_distributed``'s arithmetic, and its integer event bookkeeping is
pinned by the golden histories (``tests/golden/``); the host transports
match the ``reference`` engine (``dmtrl.fit``) to float association: they
draw the same coordinates from the same keys and read the same
round-boundary state; only the order of the per-worker reduces differs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from .. import prng
from . import omega_regularizers as omega_reg
from .distributed import MeshAxes, local_mesh
from .dmtrl import DMTRLConfig, WarmStart, resolve_device, validate_async_fields
from .mtl_data import MTLData
from .transport import _adapt_tau, _worker_delays, get_transport
from ..obs.metrics import publish_wire_stats
from ..obs.trace import span

__all__ = ["AsyncOptions", "fit_async", "_adapt_tau", "_worker_delays"]


@dataclasses.dataclass(frozen=True)
class AsyncOptions:
    """Staleness knobs of the async engine (the typed home of
    ``DMTRLConfig.tau`` & friends).

    Validation is eager: ``AsyncOptions(tau="fast")`` raises at
    construction with a clear message, not mid-fit.

    ``transport`` names the execution substrate of the snapshot/commit
    protocol (``core.transport`` registry); ``n_workers`` sets the worker
    count of the host transports (1 when unset and no mesh is given).
    """

    tau: Union[int, str] = 0  # SSP staleness bound; "auto" adapts online
    tau_max: int = 8  # clamp for the tau="auto" controller
    async_delays: Optional[Tuple[int, ...]] = None  # per-worker solve
    #               ticks; None == homogeneous workers (host transports
    #               turn them into sleep pacing)
    omega_delay: int = 0  # server commits the Sigma install may lag behind
    transport: str = "simulated"  # core.transport member name
    n_workers: Optional[int] = None  # host-transport worker count
    staleness_budget: Optional[float] = None  # tau="auto" cost target:
    #               narrow when windowed mean commit staleness exceeds it
    topology: Union[str, tuple] = "complete"  # gossip neighbor graph
    #               ("ring" | "torus" | "complete" | explicit adjacency)
    codec: str = "none"  # wire codec for the (delta_w, Sigma) messages
    #               ("none" | "bf16" | "int8"; core.wire registry)

    def __post_init__(self):
        validate_async_fields(
            self.tau,
            self.tau_max,
            self.async_delays,
            self.omega_delay,
            transport=self.transport,
            n_workers=self.n_workers,
            staleness_budget=self.staleness_budget,
            topology=self.topology,
            codec=self.codec,
        )

    def merge_into(self, cfg: DMTRLConfig) -> DMTRLConfig:
        return dataclasses.replace(
            cfg,
            tau=self.tau,
            tau_max=self.tau_max,
            async_delays=self.async_delays,
            omega_delay=self.omega_delay,
            transport=self.transport,
            n_workers=self.n_workers,
            staleness_budget=self.staleness_budget,
            topology=self.topology,
            codec=self.codec,
        )


def fit_async(
    cfg: DMTRLConfig,
    raw: MTLData,
    mesh=None,
    axes: Optional[MeshAxes] = None,
    track: bool = True,
    *,
    options: Optional[AsyncOptions] = None,
    init: Optional[WarmStart] = None,
    regularizer=None,
    device="cuda",
):
    """Algorithm 1 under the bounded-staleness execution model.

    Returns (W, sigma, state, hist): W (m, d) and Sigma (m, m) (a SigmaView
    at huge m) on ``device`` at the raw problem size, ``state`` the
    transport's padded server state, ``hist`` the objective samples plus
    the per-commit staleness events, each stamped with the transport clock.

    ``options`` (AsyncOptions) overrides the legacy staleness fields of the
    config — including ``transport=`` which picks the execution substrate;
    ``init`` warm-starts from raw-shaped (alpha, sigma, omega);
    ``regularizer`` overrides the Omega family member. The ``simulated``
    transport runs over ``mesh`` (``distributed.make_mesh``; the local
    one-device mesh on ``device`` when None); the host transports read only
    its data-axis size, when ``n_workers`` is unset. The run's device is
    the mesh's when a mesh is given, else ``device``, the card unless the
    caller passes "cpu".
    """
    device = mesh.device if mesh is not None else resolve_device(device)
    if axes is None:
        axes = MeshAxes()
    if options is not None:
        cfg = options.merge_into(cfg)
    # a config unpickled from an older version never ran __post_init__:
    # check again at fit time
    validate_async_fields(
        cfg.tau,
        cfg.tau_max,
        cfg.async_delays,
        cfg.omega_delay,
        transport=cfg.transport,
        n_workers=cfg.n_workers,
        staleness_budget=cfg.staleness_budget,
        topology=cfg.topology,
        codec=cfg.codec,
    )
    reg = omega_reg.resolve_regularizer(cfg, regularizer, m=raw.m)
    # root span + sequential driver-phase spans: "setup" / per-outer
    # "w_step" / "omega_step" / "result" tile "fit_async"
    with span("fit_async", cat="driver", transport=cfg.transport):
        with span("setup", cat="driver", transport=cfg.transport):
            spec = get_transport(cfg.transport)
            if mesh is None and spec.needs_mesh:
                mesh = local_mesh(axes, device)
            transport = spec.factory()
            transport.setup(
                cfg, raw, mesh=mesh, axes=axes, reg=reg, init=init,
                track=track, device=device,
            )
        key = prng.PRNGKey(cfg.seed)
        # rho always sees the NEWEST Sigma, installed or pending (a pending
        # install is a worker-visibility delay, not a safety-bound delay)
        rho_sigma = transport.rho_sigma()
        try:
            for p in range(cfg.outer_iters):
                rho = transport.rho_value(cfg, rho_sigma, reg)
                key, outer_key = prng.split(key)
                with span("w_step", cat="driver", outer=p):
                    transport.run_w_step(p, rho, outer_key)
                if reg.learns:
                    with span("omega_step", cat="driver", outer=p):
                        sig, om = transport.next_sigma(reg)
                        # overlapped Omega-step: defer the install into the
                        # next W-step except at the end (the last Sigma must
                        # land now)
                        defer = cfg.omega_delay > 0 and p < cfg.outer_iters - 1
                        transport.install_sigma(sig, om, defer=defer)
                        rho_sigma = sig
            with span("result", cat="driver", transport=cfg.transport):
                out = transport.result()
                ws = getattr(transport, "wire_stats", None)
                if ws is not None:
                    publish_wire_stats(ws, transport=cfg.transport)
            return out
        finally:
            transport.close()
