"""LM training loop: the train step (gradients by autograd, optional
accumulation over microbatches, the AdamW update), metric logging and
checkpoint hooks: the JAX package's ``train.loop``, on one device
(``make_train_step``) and over a mesh of process groups
(``make_sharded_train_step``).

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
from ..core import distributed as dist_mod
from ..core.dmtrl import resolve_device
from ..models import init_params, loss_fn
from .optimizer import AdamW, AdamWState, tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


def _grads(cfg: ModelConfig, params, batch: Dict[str, Tensor], shard=None):
    """(total loss, metrics, the gradients in leaf order) of ``loss_fn`` at
    ``params``. The graph is recorded on fresh views of the params, so the
    caller's tensors stay leaves without gradients."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, metrics = loss_fn(cfg, live, batch, shard=shard)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch`` holds tensors on the params' device (``tokens``, ``labels``,
    ``mask``, an encoder-decoder's ``frames``). microbatches > 1 accumulates
    the gradients of batch splits in fp32 and averages them, with the mean
    loss and aux loss, as the JAX package does. The params and the state's
    moments are updated in place (``AdamW.update``) and returned."""

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Tensor]):
        if microbatches == 1:
            loss, metrics, grads = _grads(cfg, params, batch)
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
                l, met, g = _grads(cfg, params, {k: v[i] for k, v in mb.items()})
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
    """The train step over a ``core.distributed.Mesh``, one process per
    position (the JAX package's ``make_sharded_train_step``). Returns
    ``(step, pshard, opt_shard, batch_shard)``: the step, and the
    ``models.sharding.NamedSharding`` trees of the params, the AdamW state
    and the batch, whose ``shard`` gives this rank its blocks.

    The specs are the JAX package's: ``param_shardings`` in its default
    "serve" mode, so params and both moments are split over ``model`` and
    replicated over ``data`` and ``pod``; the step count is replicated;
    the batch follows ``train_batch_pspec``, an encoder-decoder's
    ``frames`` its batch entry.

    ``step(params, opt_state, batch)`` takes this rank's blocks (the batch
    of ``global_batch`` x ``seq_len`` tokens split as ``batch_shard`` says)
    and returns ``(params, opt_state, metrics)``, the blocks updated in
    place (``AdamW.update``) where JAX donates them. Each rank computes on
    its rows with each layer's leaves gathered where the layer runs
    (``models.sharding.StepSharding``), the masked mean over the whole
    batch (the mask's sum taken over the batch axes) and the MoE's aux
    loss as its term of the batch's. Each leaf's gradient is then summed
    over the batch axes; the ranks along ``model`` hold the same rows, so
    nothing is summed over ``model``: each keeps its block. The gradient
    norm sums each leaf's squares over the axes that split that leaf. The
    metrics ``ce``, ``aux_loss``, ``grad_norm``, ``lr`` and ``loss`` are
    the whole batch's and equal on every rank.

    A batch too small for the batch axes is split along the sequence
    (``P(None, dp)``): the step first gathers tokens, labels and mask along
    the sequence, so every rank computes the whole batch (the ranks repeat
    that compute) and nothing is summed over the batch axes; this gives
    the JAX package's numbers.

    The ranks along ``model`` hold shards but repeat the same compute: the
    compute split over ``model`` (column- and row-parallel products,
    vocab-parallel cross entropy, expert parallelism) is not made here. On
    one position (the local mesh, or a one-rank world) every gather is a
    copy and every sum has one term: the step equals ``make_train_step``
    bit for bit."""
    from ..models import sharding
    from ..models.transformer import param_shapes

    if global_batch < 1 or seq_len < 1:
        raise ValueError(f"global_batch {global_batch} and seq_len {seq_len} must be positive")
    pshard = sharding.param_shardings(cfg, param_shapes(cfg), mesh)
    opt_shard = AdamWState(step=sharding.NamedSharding(mesh, sharding.P()), mu=pshard, nu=pshard)
    bspec = sharding.train_batch_pspec(mesh, global_batch)
    batch_shard: Dict[str, Any] = {k: sharding.NamedSharding(mesh, bspec)
                                   for k in ("tokens", "labels", "mask")}
    shapes = {k: (global_batch, seq_len) for k in batch_shard}
    if cfg.is_encoder_decoder:
        batch_shard["frames"] = sharding.NamedSharding(mesh, sharding.P(bspec[0], None, None))
        shapes["frames"] = (global_batch, cfg.enc_frames, cfg.d_model)
    local_shapes = {k: batch_shard[k].shard_shape(shapes[k]) for k in batch_shard}
    seq_axes = sharding.entry_axes(bspec[1])  # the sequence-split case
    grad_axes = () if seq_axes else sharding.entry_axes(bspec[0])
    shard = sharding.StepSharding(mesh, pshard, grad_axes)
    leaf_shardings = sharding.tree_leaves(pshard)
    # per leaf: the axes that split it, over which its sum of squares is
    # summed for the norm (every gradient is summed over grad_axes)
    norm_axes = [tuple(a for a in mesh.shape if a in sharding.spec_axes(s.spec))
                 for s in leaf_shardings]

    def psum_buckets(tensors, axes_of):
        """Each tensor summed over its axes: one psum per axis for each
        bucket of tensors of one dtype and one axis set."""
        out = list(tensors)
        buckets: Dict[Any, list] = {}
        for i, t in enumerate(tensors):
            if axes_of[i]:
                buckets.setdefault((axes_of[i], t.dtype), []).append(i)
        for (axes, _), idx in buckets.items():
            if all(mesh.group(a) is None for a in axes):
                continue  # the local mesh: every sum has one term
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            for a in axes:
                flat = dist_mod.psum(flat, mesh, a)
            for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape)
        return out

    def sq_reduce(sq):
        return [t.reshape(()) for t in psum_buckets([t.reshape(1) for t in sq], norm_axes)]

    def gather_sequence(batch):
        out = {}
        for k, v in batch.items():
            if k in ("tokens", "labels", "mask"):
                for a in reversed(seq_axes):
                    v = dist_mod.all_gather_dim(v, mesh, a, 1)
            out[k] = v
        return out

    def step(params, opt_state: AdamWState, batch: Dict[str, Tensor]):
        for k, v in batch.items():
            if k not in local_shapes:
                raise ValueError(f"unknown batch entry {k!r}")
            if tuple(v.shape) != local_shapes[k]:
                raise ValueError(f"batch[{k!r}] has shape {tuple(v.shape)}; this rank's block "
                                 f"of the {shapes[k]} batch is {local_shapes[k]}")
        if seq_axes:
            batch = gather_sequence(batch)
        total, metrics, grads = _grads(cfg, params, batch, shard)
        grads = psum_buckets(grads, [grad_axes] * len(grads))
        params, opt_state, opt_metrics = opt.update(
            tree_unflatten(params, grads), opt_state, params, sq_reduce=sq_reduce)
        ce, aux, loss = shard.psum_batch(
            torch.stack([metrics["ce"], metrics["aux_loss"], total])).unbind()
        out = {"ce": ce, "aux_loss": aux}
        out.update(opt_metrics)
        out["loss"] = loss
        return params, opt_state, out

    return step, pshard, opt_shard, batch_shard


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
