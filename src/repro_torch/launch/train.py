"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --reduced \
        --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --steps 10 \
        --batch 2 --seq 1024

The JAX package's launcher with the same flags, plus ``--device`` (the
card by default): random params from ``--seed``, the synthetic token
pipeline (and an encoder-decoder's stub frames), AdamW with a warmup of a
tenth of the steps (at least 5), params saved every ``--ckpt-every``
steps under ``--ckpt-dir/step_<n>``, and the logged history written to
``--history-out`` as JSON. Every arch of ``configs/`` trains on the card:
the Mamba2 archs (mamba2-780m, zamba2-2.7b) through K4 and K4-bwd, the
attention layers through K3 and K3-bwd. ``--arch`` also takes the configs'
dotted names (zamba2-2.7b, qwen1.5-4b, qwen1.5-32b).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import ARCH_ALIASES, ARCH_IDS, get_config
from ..data.tokens import SyntheticTokenPipeline, TokenPipelineConfig, embedding_side_inputs
from ..train import AdamW, TrainLogger, train
from ..train import checkpoint as ckpt


def main(argv=None):
    """Run the CLI; returns ``(params, opt_state, history)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=[*ARCH_IDS, *ARCH_ALIASES])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pipe = SyntheticTokenPipeline(
        TokenPipelineConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq,
            global_batch=args.batch,
            seed=args.seed,
        )
    )

    def data_iter():
        step = 0
        while True:
            b = pipe.batch(step)
            if cfg.is_encoder_decoder:
                b["frames"] = embedding_side_inputs(
                    "audio", args.batch, cfg.d_model, args.seed, cfg.enc_frames
                )
            yield b
            step += 1

    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 10, 5), total_steps=args.steps)
    logger = TrainLogger(every=args.log_every)

    ckpt_fn = None
    if args.ckpt_dir:
        def ckpt_fn(step, params, opt_state):
            ckpt.save(os.path.join(args.ckpt_dir, f"step_{step}"), params, step)

    t0 = time.time()
    params, opt_state, history = train(
        cfg,
        opt,
        iter(data_iter()),
        steps=args.steps,
        seed=args.seed,
        logger=logger,
        checkpoint_fn=ckpt_fn,
        checkpoint_every=args.ckpt_every,
        device=args.device,
    )
    print(f"done in {time.time()-t0:.1f}s; final loss {history[-1]['loss']:.4f}")
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    return params, opt_state, history


if __name__ == "__main__":
    main()
