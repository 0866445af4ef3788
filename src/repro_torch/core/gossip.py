"""Decentralized gossip transport: neighbor averaging instead of a server.

The paper's Algorithm 1 assumes a star topology — every worker commits its
``(delta_alpha, delta_b)`` to one parameter server that owns the coupled
state ``W = X diag(alpha) Sigma / lam``.  arXiv:2410.03403 (Distributed
Networked Multi-task Learning) analyzes the serverless regime: each node
keeps a *replica* of the shared state and averages it with graph
neighbors under a doubly-stochastic mixing matrix.  This module is that
regime, shaped so the rest of the stack cannot tell the difference:

  * ``GossipTransport`` registers as the ``gossip`` member of the
    ``core.transport`` registry and exposes the exact
    ``gate/snapshot/commit/install_sigma`` surface.
  * Topologies: ``ring`` / ``torus`` / ``complete`` / an explicit
    adjacency matrix (``cfg.topology``); the mixing matrix is the
    Metropolis–Hastings weighting, symmetric and doubly stochastic by
    construction, with ``spectral_gap`` introspection (the 1 - |lambda_2|
    quantity that rates how fast consensus contracts).

Protocol (why it matches the server member)
-------------------------------------------
Node ``g`` owns task rows ``rows_g`` and holds a full replica
``W_nodes[g]`` of the coupled state.  A commit applies the **G-scaled**
local update

    W_nodes[g] += G * Sigma[:, rows_g] @ delta_b_g / lam

so the replica *mean* moves by exactly the server's update.  At every
round boundary (SSP floor advance) one synchronous gossip exchange runs:

    W_nodes <- M @ W_nodes

and because M is doubly stochastic the exchange preserves the replica
mean exactly.  Invariant: ``mean_g W_nodes[g]`` equals the server's ``W``
trajectory at every round boundary (up to float association).  On a
complete graph the Metropolis weights degenerate to uniform ``1/G``, one
exchange reaches exact consensus, and every node serves the same boundary
state the ``threaded`` server would.  On sparser graphs nodes solve
against *locally averaged* state whose disagreement contracts at rate
``1 - spectral_gap`` per exchange.

Sigma stays driver-installed (the Omega-step is a centralized spectral
update over ``w_true()``, the replica mean); a Sigma install recomputes
``W`` from the exact global dual state and broadcasts it, resetting
consensus.

Wire accounting: each node ships its (codec-encoded, error-feedback-
corrected — ``core.wire``) replica to each neighbor per exchange;
``wire_stats['mix_bytes']`` / ``raw_mix_bytes`` make the compression
measurable, and under lossy codecs each node keeps its own replica exact
(only neighbor contributions are quantized).  Per-edge staleness
(``|completed[g] - completed[h]|`` at each exchange) lands in the event
history (``e_src/e_dst/e_stal/e_tick``) and is summarized by
``convergence.staleness_summary``.

The replicas (G, m, d) live on the run's device; like the server's state
they are replaced, never written in place, once handed out as a boundary.
"""
from __future__ import annotations

import logging
from typing import List, Tuple, Union

import numpy as np
import torch

from .transport import ThreadedTransport, TransportSpec, _host, register_transport
from .wire import ErrorFeedback
from ..obs.metrics import get_registry
from ..obs.trace import span

logger = logging.getLogger(__name__)

__all__ = [
    "GossipTransport",
    "build_adjacency",
    "mixing_matrix",
    "spectral_gap",
]

Topology = Union[str, tuple, list, np.ndarray]


# ---------------------------------------------------------------------------
# topology -> adjacency -> mixing matrix
# ---------------------------------------------------------------------------
def _torus_sides(G: int) -> Tuple[int, int]:
    """Largest a <= sqrt(G) with a | G; (a, G // a).  a == 1 degenerates
    to a ring (every G has the trivial divisor)."""
    a = 1
    for c in range(2, int(np.sqrt(G)) + 1):
        if G % c == 0:
            a = c
    return a, G // a


def build_adjacency(topology: Topology, G: int) -> np.ndarray:
    """(G, G) symmetric 0/1 adjacency, zero diagonal, connected.

    ``ring``     node i <-> i +- 1 (mod G).
    ``torus``    a x b wrap-around grid with a the largest divisor of G
                 not above sqrt(G); degenerates to a ring for prime G.
    ``complete`` all pairs — the server-equivalent anchor.
    explicit     any square 0/1 array-like; checked for symmetry, zero
                 diagonal, and connectivity.
    """
    if G < 1:
        raise ValueError(f"need G >= 1 nodes, got {G}")
    adj = np.zeros((G, G), dtype=np.int64)
    if isinstance(topology, str):
        if topology == "complete":
            adj[:] = 1
            np.fill_diagonal(adj, 0)
        elif topology == "ring":
            for i in range(G):
                adj[i, (i + 1) % G] = adj[(i + 1) % G, i] = 1
            np.fill_diagonal(adj, 0)  # G <= 2 self-loops
        elif topology == "torus":
            a, b = _torus_sides(G)
            if a == 1:
                return build_adjacency("ring", G)
            for i in range(G):
                r, c = divmod(i, b)
                for rr, cc in (
                    (r, (c + 1) % b),
                    (r, (c - 1) % b),
                    ((r + 1) % a, c),
                    ((r - 1) % a, c),
                ):
                    j = rr * b + cc
                    if j != i:
                        adj[i, j] = adj[j, i] = 1
        else:
            raise ValueError(
                f"unknown gossip topology {topology!r}; have "
                "'ring' | 'torus' | 'complete' | explicit adjacency matrix"
            )
    else:
        A = np.asarray(topology)
        if A.shape != (G, G):
            raise ValueError(
                f"explicit adjacency must be ({G}, {G}) for {G} workers; "
                f"got shape {A.shape}"
            )
        if not np.array_equal(A, A.T):
            raise ValueError("explicit adjacency must be symmetric")
        if not np.all((A == 0) | (A == 1)):
            raise ValueError("explicit adjacency entries must be 0/1")
        if np.any(np.diag(A) != 0):
            raise ValueError("explicit adjacency must have a zero diagonal")
        adj = A.astype(np.int64)
    if G > 1:
        # BFS connectivity: gossip on a disconnected graph never reaches
        # consensus, so fail loudly at setup, not as silent divergence
        seen = {0}
        frontier = [0]
        while frontier:
            i = frontier.pop()
            for j in np.flatnonzero(adj[i]):
                if int(j) not in seen:
                    seen.add(int(j))
                    frontier.append(int(j))
        if len(seen) != G:
            raise ValueError(
                f"gossip topology is disconnected: reachable component "
                f"from node 0 has {len(seen)} of {G} nodes"
            )
    return adj


def mixing_matrix(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights: symmetric, doubly stochastic.

    M[g, h] = 1 / (1 + max(deg_g, deg_h)) on edges, diagonal takes the
    slack.  Doubly stochastic => the gossip exchange preserves the replica
    mean exactly; symmetric => real eigenvalues, so the spectral gap below
    is well defined.  On a complete graph every weight is exactly 1/G.
    """
    G = adj.shape[0]
    deg = adj.sum(axis=1)
    M = np.zeros((G, G), dtype=np.float64)
    for g in range(G):
        for h in np.flatnonzero(adj[g]):
            M[g, h] = 1.0 / (1.0 + max(deg[g], deg[h]))
    np.fill_diagonal(M, 1.0 - M.sum(axis=1))
    return M


def spectral_gap(M: np.ndarray) -> float:
    """1 - |lambda_2(M)|: the per-exchange contraction rate of the
    disagreement (consensus error shrinks by (1 - gap) each exchange).
    1.0 for a complete graph (one exchange = exact consensus), -> 0 for
    long rings."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(M)))[::-1]
    if ev.size < 2:
        return 1.0
    return float(1.0 - ev[1])


# ---------------------------------------------------------------------------
# the transport member
# ---------------------------------------------------------------------------
class GossipTransport(ThreadedTransport):
    """Serverless neighbor-averaging transport (see module docstring).

    Subclasses the threaded member for its worker fan-out, SSP gate, and
    tau machinery; replaces the shared server ``W`` with per-node replicas
    ``W_nodes`` mixed at every round boundary.
    """

    name = "gossip"

    def setup(self, cfg, raw, *, mesh, axes, reg, init, track, device="cuda"):
        super().setup(
            cfg, raw, mesh=mesh, axes=axes, reg=reg, init=init, track=track, device=device
        )
        topology = getattr(cfg, "topology", "complete")
        self.adjacency = build_adjacency(topology, self.G)
        self.M = mixing_matrix(self.adjacency)
        self.spectral_gap = spectral_gap(self.M)
        self._deg = self.adjacency.sum(axis=1).astype(int)
        self._edges: List[Tuple[int, int]] = [
            (g, h)
            for g in range(self.G)
            for h in range(g + 1, self.G)
            if self.adjacency[g, h]
        ]
        dtype = self.W.dtype
        # split M into diagonal + off-diagonal: a node's own replica never
        # rides the wire, so under lossy codecs only the neighbor terms
        # see quantization
        diag = np.diag(self.M).copy()
        self._M_diag = torch.as_tensor(diag, dtype=dtype, device=self.device)
        self._M_off = torch.as_tensor(self.M - np.diag(diag), dtype=dtype, device=self.device)
        self._mix_ef = ErrorFeedback(self.codec)
        self.W_nodes = self._broadcast(self.W)
        # gossip-only event-history keys (per-edge staleness at each
        # exchange); staleness_summary picks them up when present
        for k in ("e_src", "e_dst", "e_stal", "e_tick"):
            self.hist[k] = []
        self.wire_stats["topology"] = topology if isinstance(topology, str) else "explicit"
        self.wire_stats["spectral_gap"] = self.spectral_gap
        logger.info(
            "gossip transport: %d nodes, topology %s (%d edges), "
            "spectral gap %.4f, codec %s",
            self.G,
            self.wire_stats["topology"],
            len(self._edges),
            self.spectral_gap,
            self.codec.name,
        )
        get_registry().gauge(
            "repro_gossip_spectral_gap",
            "1 - |lambda_2| of the mixing matrix (consensus contraction "
            "per exchange)",
            labels=("topology",),
        ).set(self.spectral_gap, topology=self.wire_stats["topology"])

    def _broadcast(self, W):
        return W.expand((self.G,) + tuple(W.shape)).clone()

    # -- consensus ----------------------------------------------------------
    def _consensus_w(self):
        return torch.mean(self.W_nodes, dim=0)

    def _mix(self, tick: float) -> None:
        """One synchronous gossip exchange (called under the lock at a
        round boundary): record per-edge staleness, ship each replica to
        its neighbors through the codec, contract with M."""
        with span(
            "mix",
            cat="gossip",
            n_edges=len(self._edges),
            exchange=self.wire_stats["n_exchanges"],
        ):
            self._mix_locked(tick)

    def _mix_locked(self, tick: float) -> None:
        for g, h in self._edges:
            self.hist["e_src"].append(g)
            self.hist["e_dst"].append(h)
            self.hist["e_stal"].append(abs(self.completed[g] - self.completed[h]))
            self.hist["e_tick"].append(tick)
        per_node_raw = self.W_nodes[0].numel() * self.W_nodes.element_size()
        if self.codec.name == "none" or not self._edges:
            q = self.W_nodes
            enc_nbytes = [per_node_raw] * self.G
        else:
            qs, enc_nbytes = [], []
            for g in range(self.G):
                enc = self._mix_ef.encode(g, _host(self.W_nodes[g]))
                qs.append(self.codec.decode(enc))
                enc_nbytes.append(enc.nbytes)
            q = torch.as_tensor(np.stack(qs), dtype=self.W_nodes.dtype, device=self.device)
        self.wire_stats["n_exchanges"] += 1
        self.wire_stats["mix_bytes"] += sum(
            enc_nbytes[g] * int(self._deg[g]) for g in range(self.G)
        )
        self.wire_stats["raw_mix_bytes"] += per_node_raw * int(self._deg.sum())
        self.W_nodes = self._M_diag[:, None, None] * self.W_nodes + torch.einsum(
            "gh,hmd->gmd", self._M_off, q
        )
        self.W = self._consensus_w()

    # -- protocol overrides (all under the server condition variable) -------
    def snapshot(self, worker):
        with span("snapshot", cat="transport", worker=worker), self.cond:
            self._check_abort()
            self._maybe_install(worker)
            _W_b, sigma_b = self._boundary
            # the node-LOCAL replica, live: between two exchanges only the
            # node's own commits change it
            W_rows = self.W_nodes[worker][self._rows(worker)]
            return self._boundary_snapshot(worker, W_rows, sigma_b)

    def _apply(self, worker, upd):
        # G-scaled LOCAL apply: the replica mean moves by exactly the
        # server's W update (module docstring invariant)
        nodes = self.W_nodes
        self.W_nodes = torch.cat(
            [nodes[:worker], (nodes[worker] + self.G * upd)[None], nodes[worker + 1 :]]
        )

    def _at_boundary(self, tick):
        # one gossip exchange, then freeze the boundary
        self._mix(tick)
        self._freeze_boundary()

    def _install(self, sig, om):
        # consensus reset: the server install recomputes W from the exact
        # global dual state; broadcast it, so all replicas agree and any
        # accumulated quantization residual refers to dead state
        super()._install(sig, om)
        self.W_nodes = self._broadcast(self.W)
        self._mix_ef.reset()

    # -- driver lifecycle ---------------------------------------------------
    def _begin_w_step(self, p):
        with self.cond:
            self.W = self._consensus_w()
            super()._begin_w_step(p)

    def w_true(self):
        with self.lock:
            return self._consensus_w()[: self.raw.m]

    def result(self):
        with self.lock:
            self.W = self._consensus_w()
        return super().result()


register_transport(
    TransportSpec(
        name="gossip",
        description="serverless neighbor averaging over a configurable "
        "topology (ring/torus/complete/explicit): per-node W replicas, "
        "Metropolis mixing at round boundaries; complete graph matches "
        "the threaded server",
        needs_mesh=False,
        factory=GossipTransport,
    )
)
