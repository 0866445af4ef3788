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

The port's step takes the serve-mode specs (params and both moments split
over ``model``, replicated over the batch axes) and no microbatches. JAX's
dry run takes train-mode (FSDP) specs, with microbatches above 2e9
parameters. So a train row keeps JAX's ``arg_bytes_per_device`` (3 x the
params' bytes under train-mode specs, which JAX counts for params, mu and
nu), to be held against JAX, and adds ``step_bytes_at_rest``: what the
port's step holds (params in their dtypes and two fp32 moments under its
own specs).

Prefill and decode shapes are filled analytically (``model_flops``,
``arg_bytes_per_device``) with ``"status": "analytic"``: the port has no
sharded prefill or decode step (JAX gets one from ``jit`` with
``in_shardings``), and gathering a serve-mode cache per step, with the
compute repeated on every ``model`` rank, would count collective bytes
that GSPMD does not move. ``long_500k`` on a pure full-attention arch is
``"skipped"``, as in JAX; a trace that raises is ``"error"`` with its
traceback.
"""
from __future__ import annotations

import argparse
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
from .mesh import fake_world, make_dryrun_mesh, production_layout

ANALYTIC_REASON = (
    "the port has no sharded prefill or decode step: model_flops and "
    "arg_bytes_per_device are analytic; a gathered serve-mode cache with the "
    "compute repeated on every model rank would count collective bytes that "
    "GSPMD does not move"
)
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
    """(leaf, spec) of every leaf of a ``DecodeCache``: the JAX dry run's
    ``cache_shardings`` (a stacked cache's leading layer axis replicated,
    the position replicated, the cross k/v split like the batch)."""
    from ..models.sharding import P, decode_cache_pspec, train_batch_pspec

    out = []
    if isinstance(cache.layers, dict):
        spec = decode_cache_pspec(cfg, mesh, batch, "ssm" if cfg.arch_type == "ssm" else "attn")
        out += [(t, P(*((None,) + tuple(spec[k])))) for k, t in cache.layers.items()]
    else:
        for layer, k in zip(cache.layers, cfg.layer_kinds()):
            kind = "ssm" if k == "ssm" else ("local" if k == "local" else "attn")
            spec = decode_cache_pspec(cfg, mesh, batch, kind)
            out += [(t, spec[kk]) for kk, t in layer.items()]
    out.append((cache.position, P()))
    if cache.shared is not None:
        spec = decode_cache_pspec(cfg, mesh, batch, "attn")
        out += [(t, spec[kk]) for c in cache.shared for kk, t in c.items()]
    if cache.cross is not None:
        cross = P(train_batch_pspec(mesh, batch)[0], None, None, None)
        out += [(t, cross) for kv in cache.cross for t in kv]
    return out


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
    """What the port's sharded step holds per device between steps: the
    params in their dtypes and AdamW's two fp32 moments, under the step's
    serve-mode specs (the step count's 4 bytes left out)."""
    from ..models.sharding import param_pspecs, tree_leaves
    from ..models.transformer import param_shapes

    pshapes = param_shapes(cfg)
    specs = param_pspecs(cfg, pshapes, mesh, "serve")
    return sum(t.numel() * (t.element_size() + 8) // max(_denom(s, mesh), 1)
               for t, s in zip(tree_leaves(pshapes), tree_leaves(specs)))


def trace_step(cfg: ModelConfig, shape: InputShape, mesh, counter=None) -> Costs:
    """The counts of one ``make_sharded_train_step`` step at this rank of
    ``mesh`` (``make_dryrun_mesh``, or a one-position meta mesh): meta
    params from ``param_shapes`` and the batch from ``input_specs``, each
    sharded by the step's own ``NamedSharding.shard``, and AdamW's state.
    ``counter`` (a fresh ``CostCounter`` by default) counts the step."""
    from ..models import sharding
    from ..models.transformer import param_shapes
    from ..train.loop import make_sharded_train_step
    from ..train.optimizer import AdamW

    opt = AdamW()
    step, pshard, _, bshard = make_sharded_train_step(cfg, opt, mesh, shape.global_batch,
                                                      shape.seq_len)
    params = sharding.shard_tree(pshard, param_shapes(cfg))
    opt_state = opt.init(params)
    batch = {k: bshard[k].shard(v) for k, v in input_specs(cfg, shape).items()}
    counter = counter or CostCounter()
    with counter:
        step(params, opt_state, batch)
    return counter.costs


def run_one(arch: str, shape_name: str, mesh_name: str, out_dir: str, mesh=None
            ) -> Dict[str, Any]:
    """One row: traced for a train shape (at rank 0 of ``mesh``, else of a
    fake world opened for this row), analytic for the others."""
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
        if shape.kind != "train":
            rec.update(status="analytic", reason=ANALYTIC_REASON, model_flops=flops,
                       arg_bytes_per_device=arg_bytes)
        else:
            if mesh is None:
                with fake_world(n_chips):
                    costs = trace_step(cfg, shape, make_dryrun_mesh(multi_pod=mesh_name == "multi"))
            else:
                costs = trace_step(cfg, shape, mesh)
            terms = roofline_terms(costs, arch=arch, shape=shape_name, mesh_name=mesh_name,
                                   n_chips=n_chips, model_flops=flops)
            rec.update(status="ok", arg_bytes_per_device=arg_bytes,
                       step_bytes_at_rest=step_bytes_at_rest(cfg, sm), microbatches=1,
                       **terms.to_row())
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


def run_all(archs, shapes, meshes, out_dir: str, skip_done: bool = False, echo=print):
    """Every (arch, shape) on each mesh, the fake world of a mesh opened
    once (with its groups) for all its rows. Returns the records."""
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
                            if json.load(f).get("status") in ("ok", "skipped", "analytic"):
                                continue
                    rec = run_one(arch, shape, mesh_name, out_dir, mesh=mesh)
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
    args = ap.parse_args()

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = list(MESH_NAMES) if args.mesh == "both" else [args.mesh]
    run_all(archs, shapes, meshes, args.out, args.skip_done,
            echo=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
