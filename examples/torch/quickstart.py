"""Quickstart on the port: DMTRL on the paper's Synthetic-1 dataset via
the estimator, on the card.

    PYTHONPATH=src python examples/torch/quickstart.py [--tiny] [--device cpu]

Learns 16 related binary tasks jointly through the engine-agnostic
``DMTRLEstimator`` facade, recovers the task-correlation structure, and
compares against single-task learning (the identity_stl regularizer).
The last line is ``main``'s dict as JSON.
"""
import argparse

import numpy as np

from _common import add_device, emit
from repro_torch.core import DMTRLEstimator, correlation_from_sigma, resolve_device
from repro_torch.data.synthetic import synthetic


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--tiny", action="store_true",
        help="CI-sized shapes (seconds instead of minutes)",
    )
    args = add_device(ap).parse_args(argv)
    device = resolve_device(args.device)
    if args.tiny:
        m, d, n_tr, n_te = 6, 24, 60, 30
        fit_kw = dict(outer_iters=2, rounds=4, local_iters=64)
    else:
        m, d, n_tr, n_te = 16, 100, 300, 150
        fit_kw = dict(outer_iters=4, rounds=10, local_iters=512)

    print(f"generating Synthetic-1 ({m} tasks, 3 parent groups, +- children)...")
    sp = synthetic(1, m=m, d=d, n_train_avg=n_tr, n_test_avg=n_te, seed=0)

    est = DMTRLEstimator(
        engine="reference",  # | "distributed" | "async" (core.engines)
        loss="hinge",
        lam=1e-4,
        solver="block_gram",  # local-SDCA backend (core.solver_backends)
        block_size=64,
        seed=0,
        regularizer="trace_constraint",  # the paper's Omega family member
        device=device,
        **fit_kw,
    )
    print("fitting DMTRL (Algorithm 1) via the estimator facade...")
    est.fit(sp.train)
    gaps = est.history["gap"]
    print(f"  duality gap: {gaps[0]:.3f} -> {gaps[-1]:.4f}")
    print(f"  rho per outer iteration: {[round(r, 2) for r in est.rho_per_outer_]}")

    # single-task baseline == the identity_stl member of the same family
    stl = DMTRLEstimator(
        config=est.config, regularizer="identity_stl", device=device
    ).fit(sp.train)
    acc, acc_stl = est.score(sp.test), stl.score(sp.test)
    print(f"  test accuracy: DMTRL {acc:.3f}  vs  STL {acc_stl:.3f}")

    learned = correlation_from_sigma(est.sigma_).cpu().numpy()
    iu = np.triu_indices(m, k=1)
    align = np.corrcoef(learned[iu], sp.corr_true[iu])[0, 1]
    print(f"  task-correlation recovery alignment: {align:.3f}")
    print("\nlearned correlation matrix (rounded):")
    with np.printoptions(precision=1, suppress=True, linewidth=200):
        print(learned)
    return {"gap_first": float(gaps[0]), "gap_last": float(gaps[-1]),
            "rho_per_outer": [float(r) for r in est.rho_per_outer_],
            "accuracy": acc, "accuracy_stl": acc_stl, "alignment": float(align),
            "correlation": learned.tolist()}


if __name__ == "__main__":
    emit(main())
