"""End to end on the port: pretrain a small LM backbone, then fit
DMTRL multi-task heads on its features — the full backbone <->
paper-technique bridge, on the card.

    PYTHONPATH=src python examples/torch/train_lm_mtl.py --steps 200 --arch gemma3-1b

(``--device cpu`` runs it on the CPU.) The backbone is the reduced
config; training runs the flash-attention kernel forward and backward
(the SSD chunk kernels for a Mamba2 arch), the features its forward, and
the heads' fit the SDCA solver. The last line is ``main``'s dict as JSON,
with the LM kernels' launches.
"""
import argparse

import numpy as np

from _common import add_device, emit, kernel_launches
from repro_torch.configs import get_config
from repro_torch.core import DMTRLConfig, resolve_device
from repro_torch.core import dual as dm
from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
from repro_torch.train import AdamW, TrainLogger, train
from repro_torch.train.mtl_head import build_mtl_data_from_backbone, fit_mtl_heads


def make_task_datasets(cfg, m_tasks=6, n_per_task=48, seq=32, seed=0):
    """Per-'tenant' token classification tasks: each task prefers a distinct
    token-id band; labels = whether the sequence leans into that band."""
    rng = np.random.RandomState(seed)
    tokens, labels = [], []
    V = cfg.vocab_size
    for t in range(m_tasks):
        lo = (t * V) // m_tasks
        hi = ((t + 1) * V) // m_tasks
        toks = np.zeros((n_per_task, seq), np.int32)
        y = np.zeros((n_per_task,), np.float32)
        for i in range(n_per_task):
            pos = rng.rand() < 0.5
            if pos:
                toks[i] = rng.randint(lo, hi, size=seq)
            else:
                toks[i] = rng.randint(0, V, size=seq)
            y[i] = 1.0 if pos else -1.0
        tokens.append(toks), labels.append(y)
    return tokens, labels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = add_device(ap).parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    print(f"1) pretraining backbone {cfg.name} for {args.steps} steps...")
    pipe = SyntheticTokenPipeline(
        TokenPipelineConfig(cfg.vocab_size, args.seq, args.batch, seed=0)
    )
    opt = AdamW(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    params, _, hist = train(
        cfg, opt, iter(pipe), steps=args.steps, logger=TrainLogger(every=25),
        device=device,
    )
    print(f"   loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    print("2) building per-task phi features from the backbone...")
    toks, labs = make_task_datasets(cfg)
    result = fit_mtl_heads(
        cfg,
        params,
        toks,
        labs,
        DMTRLConfig(loss="hinge", lam=1e-3, outer_iters=3, rounds=8,
                    local_iters=128, seed=0),
        device=device,
    )
    print(f"   phi dim = {result.features_dim}")

    print("3) evaluating the DMTRL heads on held-out task data...")
    toks_te, labs_te = make_task_datasets(cfg, seed=1)
    te = build_mtl_data_from_backbone(cfg, params, toks_te, labs_te, device=device)
    err = float(dm.error_rate(te, result.dmtrl.W))
    sigma_diag = np.diag(result.dmtrl.sigma.cpu().numpy())
    print(f"   multi-task head test error: {err:.3f} (chance = 0.5)")
    print("   learned task covariance diag:", np.round(sigma_diag, 3))
    return {"arch": cfg.name, "steps": args.steps,
            "losses": [h["loss"] for h in hist], "loss_first": hist[0]["loss"],
            "loss_last": hist[-1]["loss"], "phi_dim": result.features_dim,
            "test_error": err, "n_test": [int(len(y)) for y in labs_te],
            "sigma_diag": sigma_diag.tolist(),
            "launches": kernel_launches()}


if __name__ == "__main__":
    emit(main())
