"""Multi-pod dry run on the port: every (arch x input shape) on the
production meshes, as roofline terms per device, on any host (no card).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch nemotron-4-15b \\
        --shape train_4k --mesh single --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun_torch

Each run writes one JSON per (arch, shape, mesh) into --out.

The JAX package lowers and compiles each step on 512 fake XLA devices and
parses the HLO. Torch has no such compiler, so the port runs its own step
instead: a train shape traces ``train.make_sharded_train_step`` at rank 0
of a fake ``torch.distributed`` world of the mesh's size (256 or 512
ranks, ``launch.mesh.fake_world``), on ``meta`` tensors, under
``roofline.analysis.CostCounter``: FLOPs, bytes, kernel launches,
collective calls and bytes by kind, and the peak of live bytes, each per
device. The values are meaningless there (nothing is summed under the
fake backend); only shapes and counts are kept.

A train row traces the train-mode (FSDP) step with the JAX dry run's
microbatches: one row a rank above 2e9 parameters (``b_loc``
microbatches), else one; ``DRYRUN_MICROBATCHES`` overrides the count and
``DRYRUN_ZERO2=1`` passes serve-mode specs inside and train-mode specs for
the gradients (``microbatch_rule``). A step of more than two microbatches
is counted from its first two (``trace_step(scaled=True)``; the row's
``microbatch_counts`` says "scaled": the same counts as tracing them all,
held by a CPU test; ``--every-microbatch`` traces them all). A row keeps JAX's
``arg_bytes_per_device`` (3 x the params' bytes under train-mode specs,
which JAX counts for params, mu and nu), to be held against JAX, and adds
``step_bytes_at_rest``: what the step holds between steps (params in their
dtypes and two fp32 moments under the same specs). A trace that raises is
an ``"error"`` row: JAX's retry without microbatches (an XLA workaround)
has no counterpart.

Prefill and decode shapes trace the sharded serving step
(``models.make_sharded_prefill`` with JAX's ``extra_len`` of 128,
``models.make_sharded_decode_step`` on ``input_specs``' cache) the same
way, under JAX's serve-mode specs and decode cache layouts
(``sharding.decode_cache_shardings``, which ``arg_bytes_per_device`` reads
too). Their ``step_bytes_at_rest`` is the params under serve-mode specs,
plus the cache for a decode step (JAX's ``arg_bytes_per_device``). Every
traced row carries ``fits``: its bytes at rest plus its traced peak within
one card's memory (``launch.mesh.HBM_BYTES``). ``long_500k`` on a pure
full-attention arch is ``"skipped"``, as in JAX; a trace that raises is
``"error"`` with its traceback.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch

from ..configs import ARCH_IDS, get_config
from ..configs.base import ModelConfig
from ..roofline.analysis import CostCounter, Costs, roofline_terms
from .input_specs import INPUT_SHAPES, InputShape, input_specs, shape_applicable
from .mesh import HBM_BYTES, fake_world, make_dryrun_mesh, production_layout

MESH_NAMES = ("single", "multi")


class ShapeMesh:
    """A mesh that has only ``.shape``: the specs and the analytic bytes
    need no world."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


def shape_mesh(mesh_name: str) -> ShapeMesh:
    shape, axes = production_layout(multi_pod=mesh_name == "multi")
    return ShapeMesh(dict(zip(axes, shape)))


def _denom(spec, mesh) -> int:
    from ..models.sharding import entry_axes

    return math.prod(mesh.shape[a] for e in spec for a in entry_axes(e))


def _bytes_per_device(leaves, specs, mesh) -> int:
    """The JAX package's ``_bytes_per_device``: each leaf's bytes over the
    product of the axes its spec names (integer division), summed."""
    return sum(t.numel() * t.element_size() // max(_denom(s, mesh), 1)
               for t, s in zip(leaves, specs))


def _cache_leaves(cfg: ModelConfig, cache, mesh, batch: int) -> List[Tuple[torch.Tensor, Any]]:
    """(leaf, spec) of every leaf of a ``DecodeCache`` under
    ``sharding.decode_cache_shardings``: the JAX dry run's
    ``cache_shardings``, the one definition the traced decode step uses."""
    from ..models.sharding import cache_items, decode_cache_shardings

    shardings = dict(cache_items(decode_cache_shardings(cfg, mesh, batch, cache)))
    return [(t, shardings[path].spec) for path, t in cache_items(cache)]


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6 N_active tokens for a train step, 2 N_active tokens for a prefill,
    2 N_active B for a decode step (the JAX dry run's)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def arg_bytes_per_device(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    """The JAX dry run's argument bytes per device: 3 x the params' under
    train-mode specs for a train step, the params' under serve-mode specs
    for a prefill, and those plus the decode cache's for a decode step."""
    from ..models.sharding import param_pspecs, tree_leaves
    from ..models.transformer import param_shapes

    pshapes = param_shapes(cfg)
    specs = param_pspecs(cfg, pshapes, mesh, "train" if shape.kind == "train" else "serve")
    params = _bytes_per_device(tree_leaves(pshapes), tree_leaves(specs), mesh)
    if shape.kind == "train":
        return 3 * params
    if shape.kind == "prefill":
        return params
    cache = input_specs(cfg, shape)["cache"]
    leaves, cspecs = zip(*_cache_leaves(cfg, cache, mesh, shape.global_batch))
    return params + _bytes_per_device(leaves, cspecs, mesh)


def step_bytes_at_rest(cfg: ModelConfig, mesh) -> int:
    """What the port's sharded train step holds per device between steps:
    the params in their dtypes and AdamW's two fp32 moments, under the
    step's train-mode (FSDP) specs (the step count's 4 bytes left out). A
    serving step holds its ``arg_bytes_per_device``."""
    from ..models.sharding import param_pspecs, tree_leaves
    from ..models.transformer import param_shapes

    pshapes = param_shapes(cfg)
    specs = param_pspecs(cfg, pshapes, mesh, "train")
    return sum(t.numel() * (t.element_size() + 8) // max(_denom(s, mesh), 1)
               for t, s in zip(tree_leaves(pshapes), tree_leaves(specs)))


def microbatch_rule(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    """The JAX dry run's step options for a train shape on ``mesh``
    (``src/repro/launch/dryrun.py``): ``microbatches`` = the rows a rank
    holds (``b_loc``) above 2e9 parameters, else 1, or
    ``DRYRUN_MICROBATCHES``; with ``DRYRUN_ZERO2=1`` the serve-mode specs
    as ``inner_param_specs`` and the train-mode ones as ``grad_specs``."""
    from ..models.sharding import entry_axes, param_pspecs, train_batch_pspec
    from ..models.transformer import param_shapes

    b0 = entry_axes(train_batch_pspec(mesh, shape.global_batch)[0])
    n_dp = math.prod(mesh.shape[a] for a in b0)
    b_loc = max(shape.global_batch // max(n_dp, 1), 1)
    default = max(1, b_loc) if cfg.param_count() > 2e9 else 1
    out: Dict[str, Any] = {"mode": "train",
                           "microbatches": int(os.environ.get("DRYRUN_MICROBATCHES", default))}
    if os.environ.get("DRYRUN_ZERO2") == "1":
        pshapes = param_shapes(cfg)
        out["inner_param_specs"] = param_pspecs(cfg, pshapes, mesh, "serve")
        out["grad_specs"] = param_pspecs(cfg, pshapes, mesh, "train")
    return out


def _scaled(one: Costs, two: Costs, m: int) -> Costs:
    """The counts of an m-microbatch step from those of the same step run
    through its first microbatch (``one``) and its first two (``two``):
    ``one`` plus m - 1 times the second microbatch's increment. Every
    microbatch runs the same ops on the same shapes, so this equals the
    whole step's counts (held by a CPU test at m = 4); the peak is the
    larger of the two runs' (each microbatch's live set is the same)."""
    def add(a, b):
        return a + (m - 1) * (b - a)

    def add_counts(a, b):
        return collections.Counter({k: add(a.get(k, 0), b.get(k, 0)) for k in set(a) | set(b)})

    return Costs(flops=add(one.flops, two.flops), bytes=add(one.bytes, two.bytes),
                 ops=add(one.ops, two.ops),
                 kernels=add_counts(one.kernels, two.kernels),
                 kernel_flops=add_counts(one.kernel_flops, two.kernel_flops),
                 kernel_bytes=add_counts(one.kernel_bytes, two.kernel_bytes),
                 collectives=add_counts(one.collectives, two.collectives),
                 collective_bytes=add_counts(one.collective_bytes, two.collective_bytes),
                 peak_bytes=max(one.peak_bytes, two.peak_bytes))


def trace_step(cfg: ModelConfig, shape: InputShape, mesh, counter=None, *,
               scaled: bool = False, **options) -> Costs:
    """The counts of one ``make_sharded_train_step`` step at this rank of
    ``mesh`` (``make_dryrun_mesh``, or a one-position meta mesh): meta
    params from ``param_shapes`` and the batch from ``input_specs``, each
    sharded by the step's own ``NamedSharding.shard``, and AdamW's state.
    The step takes ``options`` (``mode``, ``microbatches``, ZeRO-2's
    specs), by default ``microbatch_rule``'s. ``counter`` (a fresh
    ``CostCounter`` by default) counts the step.

    ``scaled`` with more than two microbatches traces the step through its
    first microbatch and through its first two (the re-laying and the
    optimizer update whole in both) and scales the second's increment to
    all of them (``_scaled``): the same counts at about 3 / m of the
    microbatches' trace time."""
    from ..models import sharding
    from ..models.transformer import param_shapes
    from ..train.loop import _sharded_train_step
    from ..train.optimizer import AdamW

    options = {"mode": "serve", "microbatches": 1, "inner_param_specs": None,
               "grad_specs": None, **(options or microbatch_rule(cfg, shape, mesh))}
    m = options["microbatches"]
    opt = AdamW()

    def count(counter, k=None):
        step, pshard, _, bshard = _sharded_train_step(
            cfg, opt, mesh, shape.global_batch, shape.seq_len, run_microbatches=k, **options)
        batch = {key: bshard[key].shard(v) for key, v in input_specs(cfg, shape).items()}
        params = sharding.shard_tree(pshard, param_shapes(cfg))
        opt_state = opt.init(params)
        with counter:
            step(params, opt_state, batch)
        return counter.costs

    counter = counter or CostCounter()
    if scaled and m > 2:
        second = CostCounter()
        second._layouts = counter._layouts  # the meta ops' layouts, known from the first
        return _scaled(count(counter, 1), count(second, 2), m)
    return count(counter)


SERVE_EXTRA_LEN = 128  # the JAX dry run's prefill extra_len


def trace_serve(cfg: ModelConfig, shape: InputShape, mesh, counter=None,
                extra_len: int = SERVE_EXTRA_LEN) -> Costs:
    """The counts of one sharded serving step at this rank of ``mesh``: a
    prefill shape's ``make_sharded_prefill`` (``extra_len`` slots past
    the prompt) on ``input_specs``' batch, a decode shape's
    ``make_sharded_decode_step`` on its token and cache of ``seq_len``
    slots; the params from ``param_shapes``, every input sharded by the
    step's own shardings. ``counter`` (a fresh ``CostCounter`` by default)
    counts the step."""
    from ..models import make_sharded_decode_step, make_sharded_prefill, sharding
    from ..models.transformer import param_shapes

    counter = counter or CostCounter()
    specs = input_specs(cfg, shape)
    B = shape.global_batch
    if shape.kind == "prefill":
        step, pshard, bshard, _ = make_sharded_prefill(cfg, mesh, B, shape.seq_len,
                                                       extra_len=extra_len)
        args = ({k: bshard[k].shard(v) for k, v in specs.items()},)
    elif shape.kind == "decode":
        step, pshard, tshard, cshard = make_sharded_decode_step(cfg, mesh, B, shape.seq_len)
        args = (tshard.shard(specs["token"]), sharding.shard_cache(cshard, specs["cache"]))
    else:
        raise ValueError(f"{shape.name} is a {shape.kind} shape: trace_step traces it")
    params = sharding.shard_tree(pshard, param_shapes(cfg))
    with counter:
        step(params, *args)
    return counter.costs


def run_one(arch: str, shape_name: str, mesh_name: str, out_dir: str, mesh=None,
            scaled: bool = True) -> Dict[str, Any]:
    """One row, traced at rank 0 of ``mesh`` (else of a fake world opened
    for this row): the train step for a train shape, the serving step for
    the others. A train step of more than two microbatches is counted
    from its first two (``trace_step(scaled=True)``) unless ``scaled`` is
    false; the row says which (``microbatch_counts``)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "timestamp": time.time()}
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(out_dir, rec)
        return rec
    sm = shape_mesh(mesh_name)
    n_chips = math.prod(sm.shape.values())
    t0 = time.time()
    try:
        flops = model_flops(cfg, shape)
        arg_bytes = arg_bytes_per_device(cfg, shape, sm)

        def trace(m):
            if shape.kind == "train":
                return trace_step(cfg, shape, m, scaled=scaled)
            return trace_serve(cfg, shape, m)

        if mesh is None:
            with fake_world(n_chips):
                costs = trace(make_dryrun_mesh(multi_pod=mesh_name == "multi"))
        else:
            costs = trace(mesh)
        terms = roofline_terms(costs, arch=arch, shape=shape_name, mesh_name=mesh_name,
                               n_chips=n_chips, model_flops=flops)
        at_rest = step_bytes_at_rest(cfg, sm) if shape.kind == "train" else arg_bytes
        rec.update(status="ok", arg_bytes_per_device=arg_bytes, step_bytes_at_rest=at_rest,
                   fits=at_rest + costs.peak_bytes <= HBM_BYTES)
        if shape.kind == "train":
            micro = microbatch_rule(cfg, shape, sm)["microbatches"]
            rec.update(microbatches=micro, zero2=os.environ.get("DRYRUN_ZERO2") == "1",
                       microbatch_counts="scaled" if scaled and micro > 2 else "traced")
        rec.update(**terms.to_row())
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["trace_s"] = time.time() - t0
    _write(out_dir, rec)
    return rec


def _write(out_dir: str, rec: Dict[str, Any]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def run_all(archs, shapes, meshes, out_dir: str, skip_done: bool = False, echo=print,
            scaled: bool = True):
    """Every (arch, shape) on each mesh, the fake world of a mesh opened
    once (with its groups) for all its rows (``run_one``'s ``scaled``).
    Returns the records."""
    recs = []
    for mesh_name in meshes:
        sm = shape_mesh(mesh_name)
        with fake_world(math.prod(sm.shape.values())):
            mesh = make_dryrun_mesh(multi_pod=mesh_name == "multi")
            for arch in archs:
                for shape in shapes:
                    fn = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
                    if skip_done and os.path.exists(fn):
                        with open(fn) as f:
                            if json.load(f).get("status") in ("ok", "skipped"):
                                continue
                    rec = run_one(arch, shape, mesh_name, out_dir, mesh=mesh, scaled=scaled)
                    recs.append(rec)
                    if echo is not None:
                        echo(f"[{rec['status']:8s}] {arch:20s} {shape:12s} {mesh_name:6s} "
                             f"({rec.get('trace_s', 0.0):.1f}s) {rec.get('error', '')}")
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--every-microbatch", action="store_true",
                    help="trace every microbatch of a train step instead of scaling the "
                         "first two's counts (the same counts, several times slower)")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = list(MESH_NAMES) if args.mesh == "both" else [args.mesh]
    run_all(archs, shapes, meshes, args.out, args.skip_done,
            echo=lambda line: print(line, flush=True), scaled=not args.every_microbatch)


if __name__ == "__main__":
    main()
