"""The port's mesh engines in one 4-rank gloo world on the CPU.

    python -c "import torch_mesh_ranks as r; r.main(OUT_DIR)"   # tests/ on sys.path

spawns four ranks (a FileStore under OUT_DIR: no ports) that run every
multi-rank scenario of tests/test_torch_distributed.py in turn, each rank
writing its results to OUT_DIR/rank<r>.json. The ranks import only the port
and numpy; the test compares their results with the JAX package in its own
process. Not collected by pytest (no test_ prefix).
"""
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
# keys of the golden histories (tests/golden/gen_async_golden.py)
INT_KEYS = ("round", "tick", "min_round", "w_worker", "w_round", "w_staleness",
            "w_lag", "w_tick", "tau_trace")


def _problem(**kw):
    from repro_torch.data.synthetic import synthetic

    return synthetic(1, **kw).train


# the JAX multi-device test's problem and config (tests/test_distributed.py)
MESH_PROBLEM = dict(m=8, d=32, n_train_avg=70, n_test_avg=20, seed=2)


def mesh_cfg(loss):
    from repro_torch.core import DMTRLConfig

    return DMTRLConfig(loss=loss, lam=1e-3, outer_iters=2, rounds=3, local_iters=64,
                       solver="block_gram", block_size=32, seed=0)


def _fit_out(W, sigma, state, hist):
    return {"W": W.tolist(), "sigma": sigma.tolist(), "gap": hist["gap"].tolist(),
            "alpha": state.alpha.tolist()}


def scenarios():
    from repro_torch.core import (
        DMTRLConfig, fit_async, fit_distributed, get_regularizer, make_mesh,
    )
    from repro_torch.core.distributed import DistributedOptions, MeshAxes

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                           "async_histories.json")) as f:
        golden = json.load(f)
    data4 = make_mesh((WORLD,), ("data",), device="cpu")
    dmodel = make_mesh((2, 2), ("data", "model"), device="cpu")
    dpod = make_mesh((2, 2), ("data", "pod"), device="cpu")
    ax = MeshAxes(data="data")
    axm = MeshAxes(data="data", model="model")
    sp = _problem(**MESH_PROBLEM)
    out = {}

    W, s, st, h = fit_distributed(mesh_cfg("hinge"), sp, data4, ax)
    out["data4"] = _fit_out(W, s, st, h)
    out["data4"]["coords"] = [data4.coord("data")]
    for name, opts in (("model", DistributedOptions(axes=axm)),
                       ("model_hoisted", DistributedOptions(axes=axm, dist_block_hoisted=True)),
                       ("model_bf16", DistributedOptions(axes=axm, gram_bf16=True))):
        W, s, st, h = fit_distributed(mesh_cfg("squared"), sp, dmodel, options=opts)
        out[name] = _fit_out(W, s, st, h)
    W, s, st, h = fit_distributed(mesh_cfg("hinge"), sp, dpod, MeshAxes(data="data", pod="pod"))
    out["pod"] = _fit_out(W, s, st, h)
    W, s, st, h = fit_distributed(mesh_cfg("hinge"), sp, data4, ax,
                                  regularizer=get_regularizer("low_rank_diag", rank=4))
    out["low_rank"] = _fit_out(W, s, st, h)
    out["low_rank"]["U_rows"] = list(st.sigma.U.shape)
    # 6 tasks over 4 workers: 2 padded tasks
    W, s, st, h = fit_distributed(mesh_cfg("hinge"), _problem(**dict(MESH_PROBLEM, m=6)),
                                  data4, ax)
    out["padded"] = _fit_out(W, s, st, h)
    # simulated at tau = 0: the synchronous engine's arithmetic
    W, s, st, h = fit_async(mesh_cfg("hinge"), sp, data4, ax)
    out["simulated_tau0"] = _fit_out(W, s, st, h)
    out["simulated_tau0"]["ints"] = {k: h[k].astype(int).tolist() for k in INT_KEYS}
    for case in ("g4_straggler_tau1", "g4_straggler_tau4_omega2", "g4_straggler_tau_auto"):
        rec = golden[case]
        kw = dict(rec["config"])
        kw["async_delays"] = tuple(kw["async_delays"])
        _, _, st, h = fit_async(DMTRLConfig(**kw), _problem(**rec["problem"]), data4, ax)
        out[case] = {k: np.asarray(h[k]).astype(int).tolist() for k in rec["history"]}
    return out


def rank_main(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120),
    )
    try:
        out = scenarios()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(out_dir):
    mp.start_processes(rank_main, args=(out_dir,), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])
