"""Geo-distributed DMTRL on the port: one process per worker, tasks
sharded over the mesh's ``data`` axis; only delta_b vectors and task
weights cross workers.

    PYTHONPATH=src python examples/torch/distributed_workers.py [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node N \\
        examples/torch/distributed_workers.py [--device cpu]

Alone, the mesh is the local one-position mesh. Under ``torchrun`` the N
ranks form the ``data`` axis (nccl on the card, one rank a card; gloo
with ``--device cpu``) and every rank fits the same data; rank 0 prints.
The last line is ``main``'s dict as JSON.
"""
import argparse

from _common import add_device, data_mesh, emit
from repro_torch.core import DMTRLEstimator, MeshAxes, resolve_device
from repro_torch.data.synthetic import synthetic


def main(argv=None) -> dict:
    args = add_device(argparse.ArgumentParser()).parse_args(argv)
    device = resolve_device(args.device)
    with data_mesh(device) as (mesh, rank):
        say = print if rank == 0 else (lambda *a, **k: None)
        n_dev = mesh.shape["data"]
        say(f"devices: {n_dev} (each = one of the paper's workers)")
        sp = synthetic(1, m=8, d=64, n_train_avg=200, n_test_avg=60, seed=0)

        base = dict(
            loss="hinge", lam=1e-4, outer_iters=3, rounds=8, local_iters=256, seed=0
        )
        say("fitting DMTRL with tasks sharded over the 'data' axis...")
        dist = DMTRLEstimator(
            engine="distributed", mesh=mesh, axes=MeshAxes(data="data"), device=device,
            **base
        ).fit(sp.train)
        h = dist.history
        say(f"  gap: {h['gap'][0]:.3f} -> {h['gap'][-1]:.4f}")

        ref = DMTRLEstimator(engine="reference", device=device, **base).fit(sp.train)
        werr = float((dist.W_ - ref.W_).abs().max())
        say(f"  max |W_distributed - W_reference| = {werr:.2e} (bit-equal rounds)")
        say("  per-round communication = m*d floats (delta_b gather + W scatter),")
        say("  the raw task data never left its worker.")
    return {"world": n_dev, "rank": rank, "gap": [float(g) for g in h["gap"]],
            "gap_first": float(h["gap"][0]), "gap_last": float(h["gap"][-1]),
            "max_abs_w_diff": werr}


if __name__ == "__main__":
    emit(main())
