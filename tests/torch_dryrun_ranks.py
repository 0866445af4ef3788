"""The counts of the dry run's steps in one real 4-rank gloo world on the
CPU, for tests/test_torch_dryrun.py and tests/test_torch_dryrun_dmtrl.py:

    python -c "import torch_dryrun_ranks as r; r.main(OUT_DIR, MODE)"   # tests/ on sys.path

MODE "lm" runs one make_sharded_train_step step per LM_CASES entry (init
params from seed 0, a batch from a numpy seed); MODE "dmtrl" one
make_distributed_round per DMTRL_CASES entry, on zeros of each rank's
blocks (dryrun_dmtrl.trace_round). Each runs under
roofline.analysis.CostCounter, and rank 0 writes rank0.json with each
case's counts; the test traces the same cases at rank 0 of a fake world
of 4 ranks on meta tensors and holds the counts equal. The ranks import
only the port and numpy; a FileStore under OUT_DIR, no ports. Not
collected by pytest (no test_ prefix).
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
LAYOUTS = {
    "data2_model2": ((2, 2), ("data", "model")),
    "pod2_data2": ((2, 2, 1), ("pod", "data", "model")),
}
# (case, arch, layout, global batch, seq): remat on, so the recompute's
# gathers are counted too
LM_CASES = [
    ("gemma3-1b|data2_model2", "gemma3-1b", "data2_model2", 4, 40),
    ("qwen3-moe-30b-a3b|data2_model2", "qwen3-moe-30b-a3b", "data2_model2", 4, 24),
    ("mamba2-780m|pod2_data2", "mamba2-780m", "pod2_data2", 4, 40),
    ("whisper-tiny|data2_model2", "whisper-tiny", "data2_model2", 4, 16),
]
# (case, layout, mesh axes (data, model, pod), solver, dist_block_hoisted)
DMTRL_CASES = [
    ("data2_model2|block_gram", ("data", "model"), ("data", "model", None), "block_gram", False),
    ("data2_model2|hoisted", ("data", "model"), ("data", "model", None), "block_gram", True),
    ("pod2_data2|pallas_round", ("pod", "data"), ("data", None, "pod"), "pallas_round", False),
]
DMTRL_SIZE = dict(m=8, n_max=32, d=12, H=32, block=16)


def lm_config(arch):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), remat=True)


def lm_batch(cfg, B, S, seed=0):
    """The full batch in input_specs' dtypes (bf16 frames), from a seed."""
    rs = np.random.RandomState(seed)
    batch = {"tokens": torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)),
             "labels": torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)),
             "mask": torch.from_numpy((rs.rand(B, S) > 0.1).astype(np.float32))}
    if cfg.is_encoder_decoder:
        frames = rs.randn(B, cfg.enc_frames, cfg.d_model).astype(np.float32)
        batch["frames"] = torch.from_numpy(frames).to(torch.bfloat16)
    return batch


def lm_costs(cfg, mesh, B, S):
    """The counts of one sharded step on real CPU tensors at this rank."""
    from repro_torch.models import init_params, sharding
    from repro_torch.roofline.analysis import CostCounter
    from repro_torch.train import AdamW
    from repro_torch.train.loop import make_sharded_train_step

    opt = AdamW()
    step, pshard, _, bshard = make_sharded_train_step(cfg, opt, mesh, B, S)
    params = sharding.shard_tree(pshard, init_params(cfg, 0, "cpu"))
    state = opt.init(params)
    batch = {k: bshard[k].shard(v) for k, v in lm_batch(cfg, B, S).items()}
    with CostCounter() as counter:
        step(params, state, batch)
    return counter.costs


def dmtrl_config(solver, hoisted):
    from repro_torch.core import DMTRLConfig

    return DMTRLConfig(loss="hinge", lam=1e-3, local_iters=DMTRL_SIZE["H"], solver=solver,
                       block_size=DMTRL_SIZE["block"], dist_block_hoisted=hoisted)


def dmtrl_costs(mesh, axes, solver, hoisted):
    from repro_torch.core import MeshAxes
    from repro_torch.launch.dryrun_dmtrl import trace_round

    z = DMTRL_SIZE
    return trace_round(dmtrl_config(solver, hoisted), mesh, MeshAxes(*axes), z["m"],
                       z["n_max"], z["d"], 2.0)


def scenarios(mode):
    from repro_torch.core import make_mesh

    out = {}
    if mode == "lm":
        meshes = {k: make_mesh(s, n, device="cpu") for k, (s, n) in LAYOUTS.items()}
        for case, arch, lay, B, S in LM_CASES:
            out[case] = lm_costs(lm_config(arch), meshes[lay], B, S).counted()
    else:
        for case, names, axes, solver, hoisted in DMTRL_CASES:
            mesh = make_mesh((2, 2), names, device="cpu")
            out[case] = dmtrl_costs(mesh, axes, solver, hoisted).counted()
    return out


def rank_main(rank, out_dir, mode):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120),
    )
    try:
        out = scenarios(mode)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump(out, f)


def main(out_dir, mode):
    mp.start_processes(rank_main, args=(out_dir, mode), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
