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
import math
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
            grads = [a.mul_(inv) for a in acc]  # in place: one fp32 copy of the grads
            loss = loss_sum * inv
            metrics = {"ce": loss, "aux_loss": aux_sum * inv}
        params, opt_state, opt_metrics = opt.update(
            tree_unflatten(params, grads), opt_state, params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _spec_axes_of(shardings) -> list:
    from ..models import sharding

    return [sharding.spec_axes(s.spec) for s in sharding.tree_leaves(shardings)]


def _check_related(cfg: ModelConfig, name: str, specs, pshard, batch_ax) -> None:
    """Raise unless each leaf's spec in ``specs`` is its param spec with
    some batch axes left out at the minor end of their entries (where
    ``_apply_fsdp`` put them): the only reshardings the step makes."""
    from ..models import sharding

    for s, ps in zip(sharding.tree_leaves(specs), sharding.tree_leaves(pshard)):
        for i in range(max(len(s.spec), len(ps.spec))):
            axes = sharding.entry_axes(s.spec[i]) if i < len(s.spec) else ()
            have = sharding.entry_axes(ps.spec[i]) if i < len(ps.spec) else ()
            if axes != have[:len(axes)] or any(a not in batch_ax for a in have[len(axes):]):
                raise ValueError(f"{name} spec {s.spec} of {cfg.name} is not its param "
                                 f"spec {ps.spec} less some batch axes")


def make_sharded_train_step(cfg: ModelConfig, opt: AdamW, mesh, global_batch: int,
                            seq_len: int, *, mode: str = "serve", microbatches: int = 1,
                            inner_param_specs=None, grad_specs=None):
    """The train step over a ``core.distributed.Mesh``, one process per
    position (the JAX package's ``make_sharded_train_step`` with
    ``make_train_step``'s options). Returns ``(step, pshard, opt_shard,
    batch_shard)``: the step, and the ``models.sharding.NamedSharding``
    trees of the params, the AdamW state and the batch, whose ``shard``
    gives this rank its blocks.

    The specs are the JAX package's: ``param_shardings(..., mode)`` for the
    params and both moments ("serve": split over ``model``, replicated over
    ``data`` and ``pod``; "train": FSDP over those batch axes too); the step
    count replicated; the batch by ``train_batch_pspec``, an
    encoder-decoder's ``frames`` by its batch entry.

    ``step(params, opt_state, batch)`` takes this rank's blocks (the batch
    of ``global_batch`` x ``seq_len`` tokens split as ``batch_shard`` says)
    and returns ``(params, opt_state, metrics)``, the blocks updated in
    place (``AdamW.update``) where JAX donates them. Each rank computes on
    its rows: each layer's leaves are gathered over their batch axes where
    the layer runs, the gradient reduce-scattered back by the gather's
    backward (``models.sharding.StepSharding``), and the compute is split
    over ``model`` as the specs split the leaves (``sharding.ModelSplit``:
    column- and row-parallel products, split heads, channels and experts,
    the vocab-parallel cross entropy). The masked mean is over the whole
    batch (the mask's sum taken over the batch axes), the MoE's aux loss
    each rank's term of the batch's. A leaf's gradient that no gather
    summed (a 1-D leaf, or one ``_apply_fsdp`` could not split) is summed
    over the batch axes at the end of the step; the ranks along ``model``
    hold the same rows, so nothing more is summed over ``model``. The
    gradient norm sums each leaf's squares over the axes that split that
    leaf. The metrics ``ce``, ``aux_loss``, ``grad_norm``, ``lr`` and
    ``loss`` are the whole batch's and equal on every rank.

    ``microbatches`` > 1 accumulates the gradients of the batch's row
    blocks in fp32 and averages them, the loss and the aux loss, as
    ``make_train_step`` does: microbatch i is the global rows [i B/m,
    (i+1) B/m), which set its mask count and the MoE's f_e, so the step
    re-lays the batch once (a gather over the batch axes) and each rank
    takes its B / (m D) rows of each. ``inner_param_specs`` (ZeRO-2)
    gathers the params to those specs once a step for every forward and
    backward, and ``grad_specs`` holds the accumulated gradients at theirs:
    each microbatch's gradients are reduce-scattered to them. Both must be
    the param specs less some batch axes, as JAX's dry run passes them
    (serve specs inside, train specs for the gradients).

    A batch too small for the batch axes is split along the sequence
    (``P(None, dp)``): the step first gathers tokens, labels and mask along
    the sequence, so every rank computes the whole batch (the ranks repeat
    that compute, and split it into microbatches as one device does) and
    nothing is summed over the batch axes; this gives the JAX package's
    numbers.

    With the defaults on one position (the local mesh, or a one-rank
    world) nothing is split, every gather is a copy and every sum has one
    term: the step equals ``make_train_step`` bit for bit, and so do the
    train-mode and ZeRO-2 steps ``make_train_step(microbatches=m)``."""
    return _sharded_train_step(cfg, opt, mesh, global_batch, seq_len, mode, microbatches,
                               inner_param_specs, grad_specs)


def _sharded_train_step(cfg: ModelConfig, opt: AdamW, mesh, global_batch: int, seq_len: int,
                        mode: str, microbatches: int, inner_param_specs, grad_specs,
                        run_microbatches: Optional[int] = None):
    """``make_sharded_train_step``. With ``run_microbatches`` = k the step
    runs only the first k of its microbatches, and its update takes k of
    the m terms: a wrong update, built only for the dry run's scaled count
    (``launch.dryrun.trace_step``), which runs every op of the step but the
    other microbatches'."""
    from ..models import sharding
    from ..models.transformer import param_shapes

    if global_batch < 1 or seq_len < 1:
        raise ValueError(f"global_batch {global_batch} and seq_len {seq_len} must be positive")
    if microbatches < 1 or global_batch % microbatches:
        raise ValueError(f"global_batch {global_batch} does not split into {microbatches} "
                         "microbatches")
    shapes_tree = param_shapes(cfg)
    pshard = sharding.param_shardings(cfg, shapes_tree, mesh, mode)
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
    positions = math.prod(mesh.shape[a] for a in grad_axes)
    if (global_batch // microbatches) % positions:
        raise ValueError(f"a microbatch of {global_batch // microbatches} rows does not split "
                         f"over the batch axes {grad_axes} ({positions} positions)")
    batch_ax = sharding.batch_axes(mesh)

    def bind(specs, name):
        bound = sharding.tree_map(
            lambda leaf, s: sharding.NamedSharding(mesh, s), shapes_tree, specs)
        for leaf, s in zip(sharding.tree_leaves(shapes_tree), sharding.tree_leaves(bound)):
            s.check(leaf.shape)
        _check_related(cfg, name, bound, pshard, batch_ax)
        return bound

    ishard = pshard if inner_param_specs is None else bind(inner_param_specs, "inner_param_specs")
    gshard = ishard if grad_specs is None else bind(grad_specs, "grad_specs")
    p_axes, i_axes, g_axes = (_spec_axes_of(t) for t in (pshard, ishard, gshard))
    for i_a, g_a in zip(i_axes, g_axes):
        if any(a not in g_a for a in i_a):
            raise ValueError("grad_specs must hold every batch axis of inner_param_specs")
    zero2 = i_axes != p_axes
    shard = sharding.StepSharding(mesh, ishard, grad_axes)
    leaf_p, leaf_i, leaf_g = (sharding.tree_leaves(t) for t in (pshard, ishard, gshard))
    full_shapes = [tuple(t.shape) for t in sharding.tree_leaves(shapes_tree)]
    # per leaf: the axes that split it, over which its sum of squares is
    # summed for the norm; and the batch axes its gradient is still to be
    # summed over once no gather, scatter or reshard has summed it
    norm_axes = [tuple(a for a in mesh.shape if a in ax) for ax in p_axes]
    rest_axes = [tuple(a for a in grad_axes if a not in g_a and a not in p_a)
                 for g_a, p_a in zip(g_axes, p_axes)]
    batch_block = batch_shard["tokens"].block_index(0)

    def reshard(t, frm, to, summed):
        """``t`` at spec ``frm`` to spec ``to`` (they differ by batch axes):
        a gather over each axis ``to`` lacks (minor first), then over each
        axis ``to`` adds its block (major first), reduce-scattered for the
        axes in ``summed`` (a partial gradient)."""
        have, want = sharding.spec_axes(frm.spec), sharding.spec_axes(to.spec)
        for i in range(len(frm.spec)):
            for a in reversed(sharding.entry_axes(frm.spec[i])):
                if a not in want:
                    t = dist_mod.all_gather_dim(t, mesh, a, i)
        for i in range(len(to.spec)):
            for a in sharding.entry_axes(to.spec[i]):
                if a not in have:
                    t = (dist_mod.psum_scatter(t, mesh, a, i) if a in summed
                         else dist_mod.block_of(t, mesh, a, i).contiguous())
        return t

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

    def microbatch_rows(batch):
        """This rank's rows of each microbatch: JAX's global rows [i B/m,
        (i+1) B/m) split over the batch axes, from the batch gathered whole
        once (the sequence-split case holds it whole already)."""
        rows = global_batch // microbatches // positions
        full = {}
        for k, v in batch.items():
            for a in reversed(grad_axes):
                v = dist_mod.all_gather_dim(v, mesh, a, 0)
            full[k] = v
        return [{k: v[i * rows * positions + batch_block * rows:][:rows] for k, v in full.items()}
                for i in range(microbatches)]

    def to_grad_specs(grads):
        """The gradients (at the inner specs) at the grad specs, leaf by leaf:
        the list's entries are replaced as they are resharded."""
        if g_axes != i_axes:
            for j, (si, sg) in enumerate(zip(leaf_i, leaf_g)):
                grads[j] = reshard(grads[j], si, sg, grad_axes)
        return grads

    def step(params, opt_state: AdamWState, batch: Dict[str, Tensor]):
        for k, v in batch.items():
            if k not in local_shapes:
                raise ValueError(f"unknown batch entry {k!r}")
            if tuple(v.shape) != local_shapes[k]:
                raise ValueError(f"batch[{k!r}] has shape {tuple(v.shape)}; this rank's block "
                                 f"of the {shapes[k]} batch is {local_shapes[k]}")
        if seq_axes:
            batch = gather_sequence(batch)
        live = params
        if zero2:  # ZeRO-2: the params at the inner specs, once a step
            with torch.no_grad():
                live = tree_unflatten(params, [
                    reshard(p, sp, si, ()) for p, sp, si in
                    zip(tree_leaves(params), leaf_p, leaf_i)])
        if microbatches == 1:
            total, metrics, grads = _grads(cfg, live, batch, shard)
            grads = to_grad_specs(grads)
            terms = torch.stack([metrics["ce"], metrics["aux_loss"], total])
        else:
            acc = [torch.zeros(s.shard_shape(shape), dtype=torch.float32, device=p.device)
                   for s, shape, p in zip(leaf_g, full_shapes, tree_leaves(params))]
            loss_sum = aux_sum = 0.0
            for mb in microbatch_rows(batch)[:run_microbatches]:
                l, met, g = _grads(cfg, live, mb, shard)
                for j, (a, si, sg) in enumerate(zip(acc, leaf_i, leaf_g)):
                    # leaf by leaf, each microbatch gradient freed once added
                    gi, g[j] = g[j], None
                    if g_axes != i_axes:
                        gi = reshard(gi, si, sg, grad_axes)
                    a.add_(gi.float())
                del g, gi
                loss_sum = loss_sum + l
                aux_sum = aux_sum + met["aux_loss"]
            inv = 1.0 / microbatches
            grads = [a.mul_(inv) for a in acc]  # in place: one fp32 copy of the grads
            del acc
            loss = loss_sum * inv
            terms = torch.stack([loss, aux_sum * inv, loss])
        del live
        if g_axes != p_axes:
            grads = [reshard(g, sg, sp, grad_axes) for g, sg, sp in zip(grads, leaf_g, leaf_p)]
        grads = psum_buckets(grads, rest_axes)
        params, opt_state, opt_metrics = opt.update(
            tree_unflatten(params, grads), opt_state, params, sq_reduce=sq_reduce)
        ce, aux, loss = shard.psum_batch(terms).unbind()
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
