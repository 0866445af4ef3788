"""Dry run of the paper's technique on the production mesh: one DMTRL
communication round (local block-Gram SDCA + delta_b all-gather + Sigma
reduce) traced at pod scale, on any host (no card).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_dmtrl --mesh both

Configs (the JAX package's ``launch/dryrun_dmtrl.py``): m = 4096 tasks
sharded over 'data' (the paper's workers), feature dim d = 8192 sharded
over 'model' (block-Gram psums), and on the multi-pod mesh each task's
samples additionally split over 'pod'. Where JAX lowers and compiles the
round, the port runs ``core.distributed.make_distributed_round`` at rank
0 of a fake world of the mesh's size (``launch.mesh.fake_world``) on
``meta`` tensors of that rank's blocks, under
``roofline.analysis.CostCounter``. The round's key is a host tensor, as
``fit_distributed`` keeps it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from .. import prng
from ..core.distributed import MeshAxes, _axis_size, make_distributed_round
from ..core.dmtrl import DMTRLConfig
from ..roofline.analysis import CostCounter, Costs, roofline_terms
from .mesh import fake_world, make_dryrun_mesh, production_layout


def trace_round(cfg: DMTRLConfig, mesh, axes: MeshAxes, m: int, n_max: int, d: int,
                rho: float, x_dtype=torch.float32, counter=None) -> Costs:
    """The counts of one ``make_distributed_round`` at this rank of
    ``mesh`` on zeros of its blocks: (m_loc, n_loc, d_loc) x, the labels,
    the sample counts (int32), alpha, W and the (m_loc, m) Sigma rows, on
    ``mesh.device`` (``meta`` for the dry run; the counts do not depend on
    the values). ``counter`` (a fresh ``CostCounter`` by default) counts
    the round."""
    m_loc = m // _axis_size(mesh, axes.data)
    n_loc = n_max // _axis_size(mesh, axes.pod)
    d_loc = d // _axis_size(mesh, axes.model)
    round_fn = make_distributed_round(cfg, mesh, axes, m, n_max, d, rho)
    f32, dev = torch.float32, mesh.device
    args = (torch.zeros((m_loc, n_loc, d_loc), dtype=x_dtype, device=dev),
            torch.zeros((m_loc, n_loc), dtype=f32, device=dev),
            torch.zeros((m_loc,), dtype=torch.int32, device=dev),
            torch.zeros((m_loc, n_loc), dtype=f32, device=dev),
            torch.zeros((m_loc, d_loc), dtype=f32, device=dev),
            torch.zeros((m_loc, m), dtype=f32, device=dev),
            prng.PRNGKey(0))
    counter = counter or CostCounter()
    with counter:
        round_fn(*args)
    return counter.costs


def model_flops(m: int, d: int, H: int, block: int) -> float:
    """Useful FLOPs of a block-Gram round, the JAX dry run's expression
    (``src/repro/launch/dryrun_dmtrl.py:66-70``): per block q and xr 2 B d
    each, the Gram 2 B^2 d, the r update 2 B d; per task H / B blocks."""
    nb = H // block
    per_task = nb * (2 * 2 * block * d + 2 * block * block * d + 2 * block * d)
    return float(m * per_task)


def run(mesh_name: str, m: int, n_max: int, d: int, out_dir: str, H: int = 512,
        block: int = 128, bf16: bool = False, tag: str = "", x_dtype=torch.float32) -> dict:
    """One round traced at rank 0 of the ``single`` or ``multi`` production
    mesh (a fake world opened for it); writes
    ``dmtrl{tag}__wstep__{mesh_name}.json`` into ``out_dir``."""
    multi = mesh_name == "multi"
    shape, _ = production_layout(multi_pod=multi)
    n_chips = math.prod(shape)
    axes = MeshAxes(data="data", model="model", pod="pod" if multi else None)
    cfg = DMTRLConfig(
        loss="hinge", lam=1e-4, local_iters=H, solver="block_gram",
        block_size=block, gram_bf16=bf16,
        dist_block_hoisted=os.environ.get("DMTRL_BLOCK_HOISTED", "0") == "1",
    )
    rho = 4.0  # representative learned-Sigma value (Lemma 10 scale)
    t0 = time.time()
    with fake_world(n_chips):
        costs = trace_round(cfg, make_dryrun_mesh(multi_pod=multi), axes, m, n_max, d, rho,
                            x_dtype)
    terms = roofline_terms(costs, arch=f"dmtrl-m{m}-d{d}{tag}", shape=f"wstep-H{H}-B{block}",
                           mesh_name=mesh_name, n_chips=n_chips,
                           model_flops=model_flops(m, d, H, block))
    rec = {"status": "ok", "trace_s": time.time() - t0, **terms.to_row()}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"dmtrl{tag}__wstep__{mesh_name}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"== DMTRL W-step round / {mesh_name} ({n_chips} chips) ==")
    print(f"peak live bytes per device: {costs.peak_bytes}")
    print(f"compute {terms.compute_s * 1e3:.2f}ms  memory {terms.memory_s * 1e3:.2f}ms  "
          f"collective {terms.collective_s * 1e3:.2f}ms  dominant={terms.dominant}")
    print("collectives:", terms.collective_breakdown)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--n-max", type=int, default=2048)
    ap.add_argument("--d", type=int, default=8192)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--x-bf16", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--H", type=int, default=512)
    args = ap.parse_args()
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mn in meshes:
        run(mn, args.m, args.n_max, args.d, args.out, H=args.H, bf16=args.bf16, tag=args.tag,
            x_dtype=torch.bfloat16 if args.x_bf16 else torch.float32)


if __name__ == "__main__":
    main()
