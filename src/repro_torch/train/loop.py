"""LM training loop: the train step (gradients by autograd, optional
accumulation over microbatches, the AdamW update), metric logging and
checkpoint hooks. The JAX package's ``train.loop`` on one device.

On the card the gradient runs through the kernels' backward: K3-bwd for
every attention (``kernels.flash.ops.FlashAttention``) and K4-bwd for every
Mamba2 layer's chunk-local SSD (``kernels.ssd.ops.SSDChunk``), so every
arch in ``configs/`` trains there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.dmtrl import resolve_device
from ..models import init_params, loss_fn
from .optimizer import AdamW, AdamWState, tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch`` holds tensors on the params' device (``tokens``, ``labels``,
    ``mask``, an encoder-decoder's ``frames``). microbatches > 1 accumulates
    the gradients of batch splits in fp32 and averages them, with the mean
    loss and aux loss, as the JAX package does. The params and the state's
    moments are updated in place (``AdamW.update``) and returned."""

    def grads_of(params, batch):
        # fresh views of the params that record the graph; the caller's
        # tensors stay leaves without gradients
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            total, metrics = loss_fn(cfg, live, batch)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Tensor]):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def split(v):
                b = v.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
                return v.reshape((microbatches, b // microbatches) + tuple(v.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            loss_sum = aux_sum = 0.0
            for i in range(microbatches):
                l, met, g = grads_of(params, {k: v[i] for k, v in mb.items()})
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                loss_sum = loss_sum + l
                aux_sum = aux_sum + met["aux_loss"]
            inv = 1.0 / microbatches
            grads = [a * inv for a in acc]
            loss = loss_sum * inv
            metrics = {"ce": loss, "aux_loss": aux_sum * inv}
        params, opt_state, opt_metrics = opt.update(
            tree_unflatten(params, grads), opt_state, params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_sharded_train_step(cfg: ModelConfig, opt: AdamW, mesh, global_batch: int,
                            seq_len: int):
    """The JAX package's train step over a device mesh (param shardings,
    the production mesh) is not ported: it comes with the mesh engines and
    ``models/sharding.py`` (ROADMAP §A item 15). One card trains through
    ``make_train_step``."""
    raise NotImplementedError(
        "make_sharded_train_step needs the mesh engines and models/sharding.py, which are "
        "not ported yet (ROADMAP §A item 15); use make_train_step on one device"
    )


@dataclasses.dataclass
class TrainLogger:
    every: int = 10
    history: list = dataclasses.field(default_factory=list)

    def log(self, step: int, metrics: Dict[str, Tensor], t0: float):
        if step % self.every == 0:
            row = {k: float(v) for k, v in metrics.items()}  # waits for the step
            row["step"] = step
            row["elapsed_s"] = time.time() - t0
            self.history.append(row)
            print(
                f"step {step:5d}  loss {row['loss']:.4f}  ce {row['ce']:.4f}  "
                f"gnorm {row['grad_norm']:.3f}  lr {row['lr']:.2e}  "
                f"t {row['elapsed_s']:.1f}s",
                flush=True,
            )


def train(
    cfg: ModelConfig,
    opt: AdamW,
    data_iter,
    steps: int,
    seed: int = 0,
    logger: Optional[TrainLogger] = None,
    checkpoint_fn: Optional[Callable[[int, Any, Any], None]] = None,
    checkpoint_every: int = 0,
    device="cuda",
) -> Tuple[Any, AdamWState, list]:
    """Single-device training loop: random params from ``seed``
    (``models.init_params``) trained for ``steps`` steps on the batches of
    ``data_iter`` (dicts of numpy arrays, as ``data.tokens`` makes them).
    Runs on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    logger = logger or TrainLogger()
    params = init_params(cfg, seed, device)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    t0 = time.time()
    for step in range(steps):
        batch = next(data_iter)
        batch = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()
                 if v is not None}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        logger.log(step, metrics, t0)
        if checkpoint_fn and checkpoint_every and (step + 1) % checkpoint_every == 0:
            checkpoint_fn(step + 1, params, opt_state)
    return params, opt_state, logger.history
