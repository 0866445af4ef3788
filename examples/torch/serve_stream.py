"""Continuous-batching MTL serving on the port: request stream + live
hot-swap, on the card.

    PYTHONPATH=src python examples/torch/serve_stream.py [--tiny] [--device cpu]
    PYTHONPATH=src python examples/torch/serve_stream.py --tiny --interleave

Default mode fits a small DMTRL estimator, stands up the
continuous-batching scheduler (``est.serving_scheduler``), and serves a
bursty stream of per-task scoring requests with a latency SLO. Halfway
through the stream the estimator keeps training (``partial_fit``) — the
new ``(W, Sigma)`` snapshot hot-swaps into the scheduler between tiles,
without draining the queue, and the demo shows requests served on each
model version plus the final p50/p95/p99 / throughput / SLO metrics.

``--interleave`` runs the LM decode-step continuous-batching demo
instead: a warmed slot-table engine serves short generations INTERLEAVED
with long ones — shorts are injected into the running batch at
decode-step boundaries and finish while the longs keep decoding, so
time-to-first-token and short-request latency stay decoupled from the
longest in-flight generation (per-step slot occupancy shows the batch
staying busy as slots recycle). The last line is ``main``'s dict as JSON.
"""
import argparse

import numpy as np

from _common import add_device, emit, kernel_launches
from repro_torch.core import resolve_device


def run_interleave(args, device) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import (
        ContinuousBatchingScheduler,
        Request,
        ServeConfig,
        ServingEngine,
        VirtualClock,
    )

    batch, longs, shorts = (3, 1, 6) if args.tiny else (4, 2, 12)
    long_toks, short_toks = (12, 2) if args.tiny else (48, 4)
    cfg = get_config("qwen1_5-4b").reduced()
    print(f"initialising reduced {cfg.name} for the decode demo...")
    params = init_params(cfg, 0, device)
    eng = ServingEngine(
        cfg, params, ServeConfig(batch=batch, max_len=128, bucket_min=8), device=device
    )
    buckets = eng.warmup([8, 16])
    print(f"  AOT warmup done: prefill buckets {buckets}, decode + insert")

    clock = VirtualClock()
    sched = ContinuousBatchingScheduler(eng, policy="fifo", clock=clock)
    rng = np.random.RandomState(1)

    def req(n_new):
        prompt = rng.randint(2, cfg.vocab_size, size=rng.randint(2, 8))
        return Request(prompt=prompt.astype(np.int32), max_new_tokens=n_new)

    reqs = [req(long_toks) for _ in range(longs)]
    reqs += [req(short_toks) for _ in range(shorts)]
    sched.submit_many(reqs)
    finished = []
    while sched.pending or sched.in_flight:
        clock.advance(1e-3)  # 1 virtual ms per decode step
        done = sched.step()
        for r in done:
            kind = "long " if r.max_new_tokens == long_toks else "short"
            print(f"  [{clock():6.3f}s] {kind} done: {len(r.output)} tokens, "
                  f"ttft {r.ttft_s * 1e3:.0f}ms, latency {r.latency_s * 1e3:.0f}ms")
            finished.append({"kind": kind.strip(), "t_s": clock(), "tokens": len(r.output),
                             "ttft_ms": r.ttft_s * 1e3, "latency_ms": r.latency_s * 1e3})
    s = sched.metrics.summary()
    short_lat = sorted(
        r.latency_s for r in reqs if r.max_new_tokens == short_toks
    )
    long_max = max(r.latency_s for r in reqs if r.max_new_tokens == long_toks)
    print(f"served {s['completed']} requests in {s['decode_steps']} decode steps, "
          f"slot occupancy {s['slot_occupancy']:.2f}")
    print(f"  ttft p50/p99: {s['ttft']['p50_s'] * 1e3:.0f} / "
          f"{s['ttft']['p99_s'] * 1e3:.0f} ms")
    print(f"  short-request max latency {short_lat[-1] * 1e3:.0f}ms vs longest "
          f"generation {long_max * 1e3:.0f}ms — shorts do not wait for longs")
    assert short_lat[-1] < long_max, "head-of-line blocking resurfaced"
    return {"arch": cfg.name, "buckets": buckets,
            "finished": finished, "completed": s["completed"],
            "decode_steps": s["decode_steps"], "slot_occupancy": s["slot_occupancy"],
            "ttft_p50_ms": s["ttft"]["p50_s"] * 1e3, "ttft_p99_ms": s["ttft"]["p99_s"] * 1e3,
            "short_max_latency_ms": short_lat[-1] * 1e3, "long_max_latency_ms": long_max * 1e3,
            "launches": kernel_launches()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true", help="CI-sized shapes")
    ap.add_argument("--interleave", action="store_true",
                    help="LM decode-step continuous-batching demo")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    args = add_device(ap).parse_args(argv)
    device = resolve_device(args.device)

    if args.interleave:
        return run_interleave(args, device)

    from repro_torch.core import DMTRLEstimator
    from repro_torch.data.synthetic import synthetic
    from repro_torch.serve import ScoreRequest

    m, d = (6, 24) if args.tiny else (16, 100)
    n_req = args.requests or (48 if args.tiny else 400)
    sp = synthetic(1, m=m, d=d, n_train_avg=60 if args.tiny else 200,
                   n_test_avg=40, seed=0)
    print(f"fitting DMTRL ({m} tasks) for the serving demo...")
    est = DMTRLEstimator(
        loss="hinge", lam=1e-4, outer_iters=2, rounds=4, local_iters=64,
        block_size=32, seed=0, device=device,
    ).fit(sp.train)
    acc = est.score(sp.test)
    print(f"  test accuracy: {acc:.3f}")

    sched = est.serving_scheduler(batch=8, slo_s=args.slo_ms / 1e3)
    version_start = sched.version
    print(f"scheduler up: batch=8, policy=edf, slo={args.slo_ms:.0f}ms, "
          f"model v{sched.version}")

    rng = np.random.RandomState(1)

    def make_request():
        t = int(rng.randint(m))
        j = int(rng.randint(int(sp.test.n[t])))
        return ScoreRequest(task=t, x=np.asarray(sp.test.x[t, j]))

    served = {}
    swapped = False
    submitted = 0
    version_swapped = None
    newest, monotonic = 0, True  # no tile served on an older version than one before it
    while submitted < n_req or sched.pending:
        # bursty arrivals: 1..12 requests land between tiles
        for _ in range(int(rng.randint(1, 13))):
            if submitted < n_req:
                sched.submit(make_request(), deadline_s=1.0)
                submitted += 1
        for r in sched.step():
            served[r.snapshot_version] = served.get(r.snapshot_version, 0) + 1
            monotonic &= r.snapshot_version >= newest
            newest = max(newest, r.snapshot_version)
        if not swapped and submitted >= n_req // 2:
            print("  mid-stream partial_fit -> hot-swap...")
            est.partial_fit(sp.train)  # pushes the new snapshot, no drain
            swapped = True
            version_swapped = sched.version
            print(f"  now serving model v{sched.version}")

    s = sched.metrics.summary()
    lat = s["latency"]
    print(f"served {s['completed']} requests on versions "
          f"{{{', '.join(f'v{v}: {n}' for v, n in sorted(served.items()))}}}")
    print("  p50/p95/p99 latency: "
          f"{lat['p50_s'] * 1e3:.2f} / {lat['p95_s'] * 1e3:.2f} / "
          f"{lat['p99_s'] * 1e3:.2f} ms")
    print(f"  throughput: {s['throughput_rps']:.0f} req/s   "
          f"tile fill: {s['tile_fill']:.2f}   "
          f"queue depth max: {s['queue_depth_max']}")
    print(f"  SLO violations: {s['slo_violations']} "
          f"(expired: {s['expired']})   hot-swaps: {s['swaps']}")
    return {"accuracy": acc, "version_start": version_start,
            "version_swapped": version_swapped,
            "served": {str(v): n for v, n in sorted(served.items())},
            "monotonic": monotonic, "completed": s["completed"], "p50_ms": lat["p50_s"] * 1e3,
            "p95_ms": lat["p95_s"] * 1e3, "p99_ms": lat["p99_s"] * 1e3,
            "throughput_rps": s["throughput_rps"], "tile_fill": s["tile_fill"],
            "queue_depth_max": s["queue_depth_max"], "slo_violations": s["slo_violations"],
            "expired": s["expired"], "swaps": s["swaps"]}


if __name__ == "__main__":
    emit(main())
