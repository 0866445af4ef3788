"""Serving metrics: latency histograms, throughput, queue depth, SLO accounting.

One ``ServingMetrics`` object aggregates everything a scheduler run emits:

  * end-to-end latency (arrival -> completion) as a ``LatencyHistogram``
    with sample-based p50/p95/p99 percentiles (exact up to
    ``max_samples`` observations, deterministically subsampled beyond)
    plus log-spaced bucket counts,
  * request counters (submitted / completed / rejected / expired) overall
    and per task,
  * queue depth (last observed + high-water mark),
  * tile packing utilisation (filled slots / total slots of every packed
    tile — the cost of serving partial tiles through a fixed-shape step),
  * SLO-violation accounting: a completed request violates when its
    latency exceeds ``slo_s`` or it finished past its deadline; a request
    expired at admission or packing (deadline already passed) always
    counts as a violation,
  * model hot-swaps observed.

The object is passive — the scheduler computes timestamps/latencies with
ITS clock and calls the ``on_*`` observers, so a virtual clock drives the
metrics exactly like a wall clock (deterministic tests, simulated-time
load benchmarks). ``summary()`` returns a JSON-ready dict; that is the
record the JAX package's ``benchmarks/bench_serving.py`` writes to
``BENCH_serving.json``. A numpy-only copy of ``repro.serve.metrics``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

# log-spaced latency bucket upper bounds: 1us .. 100s, 4 per decade
BUCKET_BOUNDS = 10.0 ** np.linspace(-6.0, 2.0, 33)


class LatencyHistogram:
    """Latency distribution: sample-based percentiles + log bucket counts.

    Samples are retained for ``np.percentile`` quantiles — exact while
    the observation count stays within ``max_samples``; past that the
    reservoir decimates deterministically (keep every 2nd sample, double
    the retention stride), so percentiles become a uniform-stride
    approximation while memory stays bounded and bucket counts, count,
    mean and max remain exact.
    """

    def __init__(self, max_samples: int = 100_000):
        if max_samples < 2:
            raise ValueError(f"max_samples must be >= 2, got {max_samples}")
        self.max_samples = int(max_samples)
        self._samples: List[float] = []
        self._stride = 1
        self._seen = 0
        self._sum = 0.0
        self._max = 0.0
        self.counts = np.zeros(len(BUCKET_BOUNDS) + 1, np.int64)

    @property
    def count(self) -> int:
        return self._seen

    def observe(self, value_s: float) -> None:
        v = float(value_s)
        self._seen += 1
        self._sum += v
        self._max = max(self._max, v)
        self.counts[int(np.searchsorted(BUCKET_BOUNDS, v, side="left"))] += 1
        if (self._seen - 1) % self._stride == 0:
            self._samples.append(v)
            if len(self._samples) > self.max_samples:
                self._samples = self._samples[::2]
                self._stride *= 2

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), q))

    def merge(self, *others: "LatencyHistogram") -> "LatencyHistogram":
        """Combine this histogram with ``others`` into a NEW histogram
        (the inputs are untouched) — per-replica latency distributions
        roll up into one fleet-level view, and multi-run bench records
        aggregate the same way.

        Counts, sums, maxima and bucket rows merge exactly.  Percentiles
        merge from the retained samples: every input is first decimated to
        the coarsest stride among the inputs (strides are powers of two,
        so the decimation is exact), keeping each input's samples a
        uniform-stride subsample of its observations — the same guarantee
        a single over-full histogram gives — then the merged reservoir
        decimates again if it exceeds ``max_samples``.
        """
        hists = (self,) + tuple(others)
        out = LatencyHistogram(max_samples=self.max_samples)
        out._seen = sum(h._seen for h in hists)
        out._sum = sum(h._sum for h in hists)
        out._max = max(h._max for h in hists)
        out.counts = np.sum([h.counts for h in hists], axis=0)
        stride = max(h._stride for h in hists)
        samples: List[float] = []
        for h in hists:
            samples.extend(h._samples[:: stride // h._stride])
        out._stride = stride
        out._samples = samples
        while len(out._samples) > out.max_samples:
            out._samples = out._samples[::2]
            out._stride *= 2
        return out

    def buckets(self) -> List[Dict[str, float]]:
        """Non-cumulative ``{"le": bound, "count": n}`` rows (last row has
        ``le=inf``); only non-empty buckets are emitted."""
        rows = []
        for i, c in enumerate(self.counts):
            if c:
                le = (
                    float(BUCKET_BOUNDS[i])
                    if i < len(BUCKET_BOUNDS)
                    else float("inf")
                )
                rows.append({"le": le, "count": int(c)})
        return rows

    def summary(self) -> Dict[str, float]:
        n = self._seen
        return {
            "count": n,
            "mean_s": self._sum / n if n else 0.0,
            "max_s": self._max,
            "p50_s": self.percentile(50.0),
            "p95_s": self.percentile(95.0),
            "p99_s": self.percentile(99.0),
        }


def _task_row() -> Dict[str, int]:
    return {"submitted": 0, "completed": 0, "expired": 0, "slo_violations": 0}


class ServingMetrics:
    """Aggregate serving counters + SLO accounting for one scheduler."""

    def __init__(
        self,
        slo_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if slo_s is not None and slo_s <= 0:
            raise ValueError(f"slo_s must be positive, got {slo_s}")
        self.slo_s = slo_s
        self._clock = clock
        self._t0 = clock()
        self.latency = LatencyHistogram()
        self.ttft = LatencyHistogram()  # arrival -> first sampled token
        self.decode_steps = 0
        self.decode_occupied = 0
        self.decode_slots = 0
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.expired = 0
        self.slo_violations = 0
        self.swaps = 0
        self.last_version: Optional[int] = None
        self.queue_depth = 0
        self.queue_depth_max = 0
        self.tiles = 0
        self.tile_slots = 0
        self.tile_filled = 0
        self.per_task: Dict[int, Dict[str, int]] = {}

    # -- observers (called by the scheduler with ITS clock/latencies) -------
    def _task(self, task: Optional[int]) -> Optional[Dict[str, int]]:
        if task is None:
            return None
        return self.per_task.setdefault(int(task), _task_row())

    def on_submit(self, task: Optional[int] = None) -> None:
        self.submitted += 1
        row = self._task(task)
        if row is not None:
            row["submitted"] += 1

    def on_reject(self, task: Optional[int] = None) -> None:
        self.rejected += 1

    def on_expired(self, task: Optional[int] = None) -> None:
        """A request dropped because its deadline passed before it could be
        packed: always an SLO violation."""
        self.expired += 1
        self.slo_violations += 1
        row = self._task(task)
        if row is not None:
            row["expired"] += 1
            row["slo_violations"] += 1

    def on_complete(
        self, task: Optional[int], latency_s: float, violated: bool
    ) -> None:
        self.completed += 1
        self.latency.observe(latency_s)
        row = self._task(task)
        if row is not None:
            row["completed"] += 1
        if violated:
            self.slo_violations += 1
            if row is not None:
                row["slo_violations"] += 1

    def on_tile(self, filled: int, slots: int) -> None:
        self.tiles += 1
        self.tile_filled += int(filled)
        self.tile_slots += int(slots)

    def on_first_token(self, ttft_s: float) -> None:
        """A streaming engine sampled a request's FIRST token (at inject:
        the prefill logits); latency so far is the time-to-first-token."""
        self.ttft.observe(ttft_s)

    def on_decode_step(self, occupied: int, slots: int) -> None:
        """One decode step advanced ``occupied`` of ``slots`` batch rows:
        the continuous-batching utilisation signal (a head-of-line-blocked
        engine shows long tails of near-empty steps; per-slot recycling
        keeps occupancy near 1 under load)."""
        self.decode_steps += 1
        self.decode_occupied += int(occupied)
        self.decode_slots += int(slots)

    def on_swap(self, version: int) -> None:
        self.swaps += 1
        self.last_version = int(version)

    def observe_queue_depth(self, depth: int) -> None:
        self.queue_depth = int(depth)
        self.queue_depth_max = max(self.queue_depth_max, int(depth))

    # -- fleet rollup -------------------------------------------------------
    def merge(self, *others: "ServingMetrics") -> "ServingMetrics":
        """Roll this object and ``others`` up into ONE new ServingMetrics
        (inputs untouched): counters and per-task rows sum, latency/ttft
        histograms merge from retained samples (``LatencyHistogram.merge``),
        queue-depth high-water is the max across queues, ``last_version``
        the newest.  The merged elapsed time is the MAX of the inputs'
        elapsed times frozen at merge time — replicas serve the same
        wall/virtual window in parallel, so fleet throughput is total
        completions over that shared window, not over the sum.
        """
        all_m = (self,) + tuple(others)
        out = ServingMetrics(slo_s=self.slo_s, clock=self._clock)
        # freeze elapsed at merge time: rollups are point-in-time records
        elapsed = max(m.elapsed_s() for m in all_m)
        out._t0 = self._clock() - elapsed
        out.latency = self.latency.merge(*(m.latency for m in others))
        out.ttft = self.ttft.merge(*(m.ttft for m in others))
        for field in (
            "decode_steps", "decode_occupied", "decode_slots", "submitted",
            "completed", "rejected", "expired", "slo_violations", "swaps",
            "queue_depth", "tiles", "tile_slots", "tile_filled",
        ):
            setattr(out, field, sum(getattr(m, field) for m in all_m))
        out.queue_depth_max = max(m.queue_depth_max for m in all_m)
        versions = [m.last_version for m in all_m if m.last_version is not None]
        out.last_version = max(versions) if versions else None
        for m in all_m:
            for task, row in m.per_task.items():
                dst = out.per_task.setdefault(task, _task_row())
                for k, v in row.items():
                    dst[k] += v
        return out

    # -- derived ------------------------------------------------------------
    def elapsed_s(self) -> float:
        return self._clock() - self._t0

    def throughput(self) -> float:
        """Completed requests per (scheduler-clock) second."""
        dt = self.elapsed_s()
        return self.completed / dt if dt > 0 else 0.0

    def tile_fill(self) -> float:
        """Mean fraction of tile slots carrying real requests."""
        return self.tile_filled / self.tile_slots if self.tile_slots else 0.0

    def slot_occupancy(self) -> float:
        """Mean fraction of decode-batch rows advancing a live request
        per decode step (streaming engines only)."""
        return (
            self.decode_occupied / self.decode_slots if self.decode_slots else 0.0
        )

    def summary(self) -> Dict[str, object]:
        """JSON-ready snapshot (the ``BENCH_serving.json`` row shape)."""
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "expired": self.expired,
            "slo_s": self.slo_s,
            "slo_violations": self.slo_violations,
            "swaps": self.swaps,
            "last_version": self.last_version,
            "elapsed_s": self.elapsed_s(),
            "throughput_rps": self.throughput(),
            "queue_depth_max": self.queue_depth_max,
            "tiles": self.tiles,
            "tile_fill": self.tile_fill(),
            "decode_steps": self.decode_steps,
            "slot_occupancy": self.slot_occupancy(),
            "ttft": self.ttft.summary(),
            "latency": self.latency.summary(),
            "latency_buckets": self.latency.buckets(),
            "per_task": {str(k): dict(v) for k, v in sorted(self.per_task.items())},
        }
