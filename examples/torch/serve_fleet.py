"""Fleet serving on the port: N replicas, task-affinity routing, rolling
hot-swap, on the card.

    PYTHONPATH=src python examples/torch/serve_fleet.py [--tiny] [--device cpu]

Fits a small DMTRL estimator, stands up a replica fleet behind the
task-affinity router (``est.serving_fleet``), and pushes a bursty stream
of per-task scoring requests through it:

  * requests are pinned to replicas by consistent hashing on task id
    (hot per-task state stays put; backlogged homes spill to the least
    loaded replica),
  * mid-stream the estimator keeps training (``partial_fit``) — the new
    ``(W, Sigma)`` rolls across the fleet ONE replica per router step,
    while every client session holds a monotonic-read token: no client
    ever observes the model version go backwards, even mid-roll,
  * then one replica "crashes" (its queue fails over to the survivors,
    stamps intact) and is restored (model caught up first),
  * the final summary is the fleet-level metrics rollup
    (``ServingMetrics.merge`` across replicas) plus the router's own
    shed/spill/failover counters.

The last line is ``main``'s dict as JSON.
"""
import argparse

import numpy as np

from _common import add_device, emit
from repro_torch.core import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="CI-sized shapes")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    args = add_device(ap).parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.core import DMTRLEstimator
    from repro_torch.data.synthetic import synthetic
    from repro_torch.serve import ScoreRequest

    m, d = (6, 24) if args.tiny else (16, 100)
    n_req = args.requests or (60 if args.tiny else 600)
    sp = synthetic(1, m=m, d=d, n_train_avg=60 if args.tiny else 200,
                   n_test_avg=40, seed=0)
    print(f"fitting DMTRL ({m} tasks) for the fleet demo...")
    est = DMTRLEstimator(
        loss="hinge", lam=1e-4, outer_iters=2, rounds=4, local_iters=64,
        block_size=32, seed=0, device=device,
    ).fit(sp.train)
    acc = est.score(sp.test)
    print(f"  test accuracy: {acc:.3f}")

    router = est.serving_fleet(
        n_replicas=args.replicas, batch=8, slo_s=args.slo_ms / 1e3
    )
    router.warmup()  # one compile, shared by every homogeneous replica
    version_start = router.version
    print(f"fleet up: {router.n_replicas} replicas, batch=8, "
          f"slo={args.slo_ms:.0f}ms, model v{router.version}")
    homes = {}
    for t in range(m):
        homes.setdefault(router.home_of(t), []).append(t)
    print("  task affinity: " + "  ".join(
        f"replica {rid} <- tasks {ts}" for rid, ts in sorted(homes.items())
    ))

    rng = np.random.RandomState(1)
    token = router.session()  # ONE client session: monotonic reads

    def make_request():
        t = int(rng.randint(m))
        j = int(rng.randint(int(sp.test.n[t])))
        return ScoreRequest(task=t, x=np.asarray(sp.test.x[t, j]))

    served = {}
    floors_ok = True
    submitted = 0
    swapped = crashed = restored = False
    while submitted < n_req or router.pending:
        for _ in range(int(rng.randint(1, 13))):
            if submitted < n_req:
                out = router.submit(make_request(), client=token)
                assert out.admitted, out
                submitted += 1
        floor = token.min_version
        for r in router.step():
            served[r.snapshot_version] = served.get(r.snapshot_version, 0) + 1
            floors_ok &= r.snapshot_version >= floor
        if not swapped and submitted >= n_req // 3:
            print("  mid-stream partial_fit -> rolling hot-swap...")
            est.partial_fit(sp.train)  # rolls one replica per router step
            swapped = True
            target, rolling = router.version, router.roll_pending
            print(f"  fleet target v{router.version} "
                  f"({router.roll_pending} replicas still rolling)")
        if swapped and not crashed and submitted >= n_req // 2:
            moved = router.fail_replica(1, "demo crash")
            crashed = True
            print(f"  replica 1 down: {moved} queued requests re-pinned "
                  f"onto {router.n_up} survivors")
        if crashed and not restored and submitted >= (2 * n_req) // 3:
            router.restore_replica(1)
            restored = True
            restored_at = router.replica(1).scheduler.version
            print(f"  replica 1 restored at v{restored_at}")

    assert floors_ok, "a client observed the model version regress"
    s = router.metrics().summary()
    lat = s["latency"]
    c = router.counters
    print(f"served {s['completed']} requests on versions "
          f"{{{', '.join(f'v{v}: {n}' for v, n in sorted(served.items()))}}} "
          f"-- no version ever regressed for the client")
    print("  fleet p50/p95/p99 latency: "
          f"{lat['p50_s'] * 1e3:.2f} / {lat['p95_s'] * 1e3:.2f} / "
          f"{lat['p99_s'] * 1e3:.2f} ms   throughput: "
          f"{s['throughput_rps']:.0f} req/s")
    print(f"  router: {c['spills']} spills, {c['shed']} shed, "
          f"{c['failovers']} failover ({c['requeued']} re-pinned), "
          f"{c['restarts']} restart, {c['rolled_installs']} rolled installs")
    per_replica = router.summary()["per_replica"]
    print("  per replica: " + "  ".join(
        f"[{p['id']}] v{p['version']} done={p['completed']}" for p in per_replica
    ))
    return {"accuracy": acc, "replicas": router.n_replicas, "version_start": version_start,
            "homes": {str(rid): ts for rid, ts in sorted(homes.items())},
            "target_version": target, "roll_pending": rolling, "moved": moved,
            "restored_version": restored_at,
            "served": {str(v): n for v, n in sorted(served.items())},
            "monotonic_reads": bool(floors_ok), "completed": s["completed"],
            "p50_ms": lat["p50_s"] * 1e3, "p95_ms": lat["p95_s"] * 1e3,
            "p99_ms": lat["p99_s"] * 1e3, "throughput_rps": s["throughput_rps"],
            "router": {k: c[k] for k in ("spills", "shed", "failovers", "requeued",
                                         "restarts", "rolled_installs")},
            "per_replica": [{k: p[k] for k in ("id", "version", "completed")}
                            for p in per_replica]}




if __name__ == "__main__":
    emit(main())
