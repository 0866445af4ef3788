"""Batched serving demos on the port, on the card.

    PYTHONPATH=src python examples/torch/serve_batch.py --arch mamba2-780m  # LM decode demo
    PYTHONPATH=src python examples/torch/serve_batch.py --mtl [--tiny]      # MTL scoring demo

(``--device cpu`` runs either on the CPU.) The LM path exercises prefill
+ decode with KV / SSM-state caches through the flash-attention and SSD
chunk kernels; the ``--mtl`` path fits a small DMTRL estimator and serves
per-task scoring requests through the batched MTL scoring engine
(serve/mtl.py). The last line is ``main``'s dict as JSON, with the LM
kernels' launches.
"""
import argparse

import numpy as np

from _common import add_device, emit, kernel_launches
from repro_torch.core import resolve_device


def lm_demo(arch: str, max_new: int, device) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    cfg = get_config(arch).reduced()
    print(f"loading {cfg.name} (reduced) ...")
    params = init_params(cfg, 0, device)
    engine = ServingEngine(cfg, params, ServeConfig(batch=4, max_len=128), device=device)

    rng = np.random.RandomState(0)
    reqs = [
        Request(prompt=rng.randint(2, cfg.vocab_size, size=n).astype(np.int32),
                max_new_tokens=max_new)
        for n in (5, 9, 3)
    ]
    print(f"serving {len(reqs)} requests (batched prefill + decode loop)...")
    done = engine.run(reqs)
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: prompt[{r.prompt.shape[0]} toks] -> {r.output}")
    return {"arch": cfg.name, "prompt_lens": [int(r.prompt.shape[0]) for r in done[:3]],
            "outputs": [[int(t) for t in r.output] for r in done[:3]]}


def mtl_demo(tiny: bool, device) -> dict:
    from repro_torch.core import DMTRLEstimator
    from repro_torch.data.synthetic import synthetic
    from repro_torch.serve import ScoreRequest

    m, d = (6, 24) if tiny else (16, 100)
    n_tr = 60 if tiny else 200
    print(f"fitting DMTRL on Synthetic-1 ({m} tasks) for the scoring demo...")
    sp = synthetic(1, m=m, d=d, n_train_avg=n_tr, n_test_avg=40, seed=0)
    est = DMTRLEstimator(
        loss="hinge", lam=1e-4, outer_iters=2, rounds=4, local_iters=64,
        block_size=32, seed=0, device=device,
    ).fit(sp.train)
    acc = est.score(sp.test)
    print(f"  test accuracy: {acc:.3f}")

    engine = est.scoring_engine(batch=4)
    rng = np.random.RandomState(1)
    reqs = []
    for _ in range(7):  # odd count: exercises the padded final batch
        t = int(rng.randint(m))
        j = int(rng.randint(int(sp.test.n[t])))
        reqs.append(ScoreRequest(task=t, x=np.asarray(sp.test.x[t, j])))
    print(f"serving {len(reqs)} scoring requests (batch=4, fixed-shape step)...")
    done = engine.run(reqs)
    for i, r in enumerate(done):
        print(f"  req{i}: task={r.task}  score={r.score:+.3f}  label={r.label:+.0f}")
    return {"accuracy": acc,
            "requests": [{"task": int(r.task), "score": float(r.score),
                          "label": float(r.label)} for r in done]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mtl", action="store_true",
                    help="run the MTL scoring demo instead of the LM demo")
    ap.add_argument("--tiny", action="store_true",
                    help="CI-sized shapes for the MTL demo")
    args = add_device(ap).parse_args(argv)
    device = resolve_device(args.device)
    if args.mtl:
        return mtl_demo(args.tiny, device)
    from repro_torch.configs import ARCH_IDS

    if args.arch not in ARCH_IDS:
        raise SystemExit(f"unknown arch {args.arch!r}; have {sorted(ARCH_IDS)}")
    out = lm_demo(args.arch, args.max_new, device)
    out["launches"] = kernel_launches()
    return out


if __name__ == "__main__":
    emit(main())
