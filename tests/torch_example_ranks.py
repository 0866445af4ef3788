"""The port's two mesh examples in one 4-rank gloo world on the CPU.

    python -c "import torch_example_ranks as r; r.main(OUT_DIR)"   # tests/ on sys.path

spawns four ranks (a FileStore under OUT_DIR: no ports). Each rank runs
examples/torch/distributed_workers.py's and async_workers.py's ``main``
with ``--device cpu`` over the world (the examples take a world that is
already made as their ``data`` axis), and the async example's synchronous
anchor, ``fit_distributed`` on the same problem and config, then writes
OUT_DIR/rank<r>.json. Rank 0 also runs the async example's host
transports and writes its trace to OUT_DIR/trace.json. The ranks import
only the port and numpy. Not collected by pytest (no test_ prefix).
"""
import datetime
import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "torch")


def rank_main(rank, out_dir):
    torch.set_num_threads(1)
    sys.path.insert(0, EXAMPLES)
    import async_workers
    import distributed_workers
    from repro_torch.core import DMTRLConfig, MeshAxes, fit_distributed, make_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120),
    )
    try:
        out = {"distributed_workers": distributed_workers.main(["--device", "cpu"])}
        mesh = make_mesh((WORLD,), ("data",), device="cpu")
        _, _, _, hist = fit_distributed(DMTRLConfig(**async_workers.base_config(True)),
                                        async_workers.problem(), mesh, MeshAxes(data="data"))
        out["fit_distributed_gap"] = hist["gap"].tolist()
        # last: rank 0 goes on to the host transports alone
        out["async_workers"] = async_workers.main(
            ["--device", "cpu", "--tiny", "--trace", os.path.join(out_dir, "trace.json")])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(out_dir):
    mp.start_processes(rank_main, args=(out_dir,), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])
