"""Bounded-staleness DMTRL with a straggler worker on the port, via the
estimator.

The mesh's workers (one process each), the last one 4x slower. The
synchronous engine barriers every round on the straggler; the async
engine (tau > 0) lets the fast workers keep committing against
bounded-stale snapshots, so the duality gap falls much earlier on the
simulated wall clock. Then the same protocol over the host transports:
a real parameter server (8 worker threads) and serverless gossip (8
nodes), which need no mesh.

    PYTHONPATH=src python examples/torch/async_workers.py [--device cpu]
    PYTHONPATH=src python examples/torch/async_workers.py --trace out.json   # span tracing on
    PYTHONPATH=src python examples/torch/async_workers.py --tiny             # CI smoke schedule
    PYTHONPATH=src torchrun --standalone --nproc-per-node N examples/torch/async_workers.py

Alone, the mesh is the local one-position mesh; under ``torchrun`` the N
ranks form the ``data`` axis (nccl on the card, one rank a card; gloo
with ``--device cpu``); rank 0 prints and writes the trace.

With ``--trace`` the threaded and gossip runs execute under the ``obs``
span tracer and the whole run is exported as Chrome-trace JSON — open
``chrome://tracing`` (or https://ui.perfetto.dev) and load the file to
see every worker thread's gate/snapshot/solve/commit timeline nested
under its rounds, plus the outer loop's W-step/Omega-step alternation. The
last line is ``main``'s dict as JSON.
"""
import argparse
import os

from _common import add_device, data_mesh, emit
from repro_torch import obs
from repro_torch.core import AsyncOptions, DMTRLEstimator, MeshAxes, resolve_device
from repro_torch.core import convergence as cv
from repro_torch.core.gossip import build_adjacency, mixing_matrix, spectral_gap
from repro_torch.data.synthetic import synthetic

HOST_WORKERS = 8  # the host transports' workers (threads, gossip nodes)


def stragglers(n):
    return (1,) * (n - 1) + (4,)  # the last worker is a 4x straggler


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--trace", metavar="OUT.json", default=None,
        help="enable span tracing and write a Chrome-trace JSON here",
    )
    ap.add_argument(
        "--tiny", action="store_true",
        help="short schedule (CI examples-smoke)",
    )
    args = add_device(ap).parse_args(argv)
    device = resolve_device(args.device)
    with data_mesh(device) as (mesh, rank):
        out = mesh_runs(args, device, mesh, rank)
    if rank == 0:  # the host transports own their workers: one run, not one a rank
        out.update(host_runs(args, device))
    return out


def problem():
    return synthetic(1, m=8, d=48, n_train_avg=120, n_test_avg=40, seed=0).train


def base_config(tiny: bool) -> dict:
    return dict(
        loss="hinge", lam=1e-4, outer_iters=2,
        rounds=3 if tiny else 8,
        local_iters=32 if tiny else 128, seed=0,
    )


def mesh_runs(args, device, mesh, rank) -> dict:
    """The synchronous and the async engine over the mesh (every rank)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    n_dev = mesh.shape["data"]
    say(f"devices: {n_dev} (each = one worker group)")
    train = problem()
    delays = stragglers(n_dev)

    base = base_config(args.tiny)
    ax = MeshAxes(data="data")

    say("synchronous (every round barriers on the straggler)...")
    sync = DMTRLEstimator(
        engine="distributed", mesh=mesh, axes=ax, device=device, **base
    ).fit(train)
    sync_ticks = cv.sync_effective_ticks(sync.history, delays)

    say("async, tau=2, deterministic straggler schedule...")
    anc = DMTRLEstimator(
        engine="async", mesh=mesh, axes=ax, device=device,
        async_options=AsyncOptions(tau=2, async_delays=delays), **base
    ).fit(train)
    a_ticks, a_gaps = cv.effective_gap_curve(anc.history)

    target = 2.0 * sync.history["gap"][-1]
    t_sync = cv.ticks_to_gap(sync_ticks, sync.history["gap"], target)
    t_async = cv.ticks_to_gap(a_ticks, a_gaps, target)
    say(f"  final gap      sync {sync.history['gap'][-1]:.4f}  async {a_gaps[-1]:.4f}")
    say(f"  ticks to gap<={target:.4f}:  sync {t_sync:.0f}  async {t_async:.0f}")
    s = cv.staleness_summary(anc.history)
    say(
        f"  staleness: max {s['max_staleness']:.0f} commits, "
        f"mean {s['mean_staleness']:.2f}, max lag {s['max_lag']:.0f} rounds"
    )
    return {
        "world": n_dev, "rank": rank, "delays": list(delays),
        "sync_gap": [float(g) for g in sync.history["gap"]],
        "sync_final_gap": float(sync.history["gap"][-1]), "async_final_gap": float(a_gaps[-1]),
        "target": float(target), "ticks_sync": float(t_sync), "ticks_async": float(t_async),
        "staleness": {k: float(s[k]) for k in ("max_staleness", "mean_staleness", "max_lag")},
    }


def host_runs(args, device) -> dict:
    """The threaded parameter server and gossip, 8 workers each, with the
    span tracer on under ``--trace``."""
    train = problem()
    base = base_config(args.tiny)

    # from here on the transports are REAL (worker threads): turn the span
    # tracer on so the runs land in the Chrome trace when --trace is given
    if args.trace:
        obs.enable(clear=True)

    # same protocol, different substrate: a REAL in-host parameter server
    # (worker threads, lock-protected versioned state, nondeterministic
    # arrival order). No mesh needed — the transport owns the workers.
    host_delays = stragglers(HOST_WORKERS)
    print("async, tau=2, threaded transport (real parameter server)...")
    thr = DMTRLEstimator(
        engine="async", device=device,
        async_options=AsyncOptions(
            tau=2, async_delays=host_delays, transport="threaded", n_workers=HOST_WORKERS
        ),
        **base,
    ).fit(train)
    st = cv.staleness_summary(thr.history)
    print(
        f"  final gap {thr.history['gap'][-1]:.4f}, "
        f"staleness mean {st['mean_staleness']:.2f} "
        f"(max lag {st['max_lag']:.0f} <= tau), "
        f"gate refusals {thr.history['gate_refusals'][-1]:.0f}"
    )

    # serverless: no parameter server at all. Each node keeps a W replica,
    # commits locally, and averages with graph neighbors (Metropolis
    # weights) at every round boundary; the int8 wire codec quantizes the
    # exchanged replicas with error feedback (core/wire.py). Sparse graphs
    # pay a consensus tax set by the mixing matrix's spectral gap — on a
    # ring of 8 it is 0.195 (slow), on a 2x4 torus 0.500 — so the torus
    # run below doubles the rounds to buy enough exchanges and lands
    # within reach of the parameter-server gap above.
    print("async, tau=2, gossip transport (torus topology, int8 wire)...")
    gaps = {}
    for topo in ("ring", "torus", "complete"):
        gaps[topo] = spectral_gap(mixing_matrix(build_adjacency(topo, HOST_WORKERS)))
        print(f"    spectral gap {topo:9s} {gaps[topo]:.3f}")
    gsp = DMTRLEstimator(
        engine="async", device=device,
        async_options=AsyncOptions(
            tau=2, async_delays=host_delays, transport="gossip",
            n_workers=HOST_WORKERS, topology="torus", codec="int8",
        ),
        **dict(base, rounds=2 * base["rounds"]),
    ).fit(train)
    sg = cv.staleness_summary(gsp.history)
    print(
        f"  final gap {gsp.history['gap'][-1]:.4f}, "
        f"spectral gap {gaps['torus']:.3f} (consensus contraction/exchange), "
        f"{sg['n_exchanges']} edge exchanges, "
        f"edge staleness mean {sg['mean_edge_staleness']:.2f} "
        f"max {sg['max_edge_staleness']:.0f}"
    )
    out = {
        "threaded": {"final_gap": float(thr.history["gap"][-1]),
                     "mean_staleness": float(st["mean_staleness"]),
                     "max_lag": float(st["max_lag"]),
                     "gate_refusals": float(thr.history["gate_refusals"][-1])},
        "spectral_gaps": gaps,
        "gossip": {"final_gap": float(gsp.history["gap"][-1]),
                   "n_exchanges": int(sg["n_exchanges"]),
                   "mean_edge_staleness": float(sg["mean_edge_staleness"]),
                   "max_edge_staleness": float(sg["max_edge_staleness"])},
    }

    if args.trace:
        n = obs.export_chrome(args.trace)
        obs.disable()
        breakdown = obs.phase_breakdown()
        top = sorted(
            breakdown.items(), key=lambda kv: -kv[1]["total_s"]
        )[:6]
        print(f"trace: {n} spans -> {os.path.abspath(args.trace)}")
        print("  top phases by inclusive wall-clock:")
        for name, row in top:
            print(
                f"    {name:16s} {row['count']:5d} x "
                f"{row['mean_s'] * 1e3:8.2f} ms = {row['total_s']:.3f} s"
            )
        print("  open chrome://tracing (or ui.perfetto.dev) and load the file")
        out["trace"] = {"spans": n, "top": [
            {"name": name, "count": row["count"], "total_s": row["total_s"]}
            for name, row in top]}
    return out


if __name__ == "__main__":
    emit(main())
