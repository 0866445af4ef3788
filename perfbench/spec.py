"""The benchmark's data files, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the harness reads
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``limits/<cell>.json``. A configuration names its generator, the
``generate(seed=..., **params)`` of ``data/<generator>.py``, and each
per-layer metric of the cell is the ``read(record)`` of
``metrics/<metric>.py``. Adding a dataset, a configuration, a traffic mix, a
cell or a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[Dict] = None, here: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    bench = bench if bench is not None else benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf:
        raise KeyError(f"workload {name!r} names the unknown config {w['config']!r}")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(here / "configs" / f"{w['config']}.json"),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def _module(kind: str, name: str, here: Path = HERE):
    """The module of ``<kind>/<name>.py``, loaded by path (a name may hold
    dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    if spec is None or spec.loader is None or not path.is_file():
        raise ImportError(f"no {kind} file for {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(metric: str, here: Path = HERE):
    """The module of ``metrics/<metric>.py``."""
    return _module("metrics", metric, here)


def reader(metric: str, here: Path = HERE) -> Callable[[Dict], Optional[float]]:
    """``read(record)`` of ``metrics/<metric>.py``: the metric's value, or
    None where the record holds nothing for it."""
    return metric_module(metric, here).read


def make_data(config: Dict, seed: int, here: Path = HERE):
    """The configuration's arrays (``data.arrays.TaskArrays``), made by the
    ``generate`` of ``data/<generator>.py`` from ``seed``."""
    return _module("data", config["generator"], here).generate(seed=seed, **config["params"])
