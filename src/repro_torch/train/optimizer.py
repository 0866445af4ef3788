"""AdamW with fp32 moments over (possibly bf16) params: the JAX package's
``train.optimizer``, with the update made in place.

Params, gradients and moments are nested dicts of tensors (the model's
param tree). ``tree_leaves`` walks them in the JAX package's leaf order
(dict keys sorted), so the global gradient norm sums the leaves in the
same order as the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor


def tree_leaves(tree) -> List[Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in JAX's order
    (dict keys sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the matching leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    return _build(like, iter(leaves))


def _build(node, it):
    # a module-level function: a nested recursive one would close over
    # itself and the iterator, a cycle that kept ``leaves`` (a train step's
    # gradients) alive until the garbage collector ran
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}  # leaves in sorted-key order
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        items = [_build(x, it) for x in node]
        return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
    return next(it)


class AdamWState(NamedTuple):
    step: Tensor  # int32 scalar: updates made so far
    mu: Any  # fp32 first moments, the params' tree
    nu: Any  # fp32 second moments


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            mu=tree_map(f32, params),
            nu=tree_map(f32, params),
        )

    def schedule(self, step) -> Tensor:
        """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac``."""
        s = torch.as_tensor(step).float()
        warm = torch.clamp(s / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (s - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0
        )
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1.0 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def update(self, grads, state: AdamWState, params,
               sq_reduce: Optional[Callable[[List[Tensor]], List[Tensor]]] = None
               ) -> Tuple[Any, AdamWState, Dict]:
        """One step: the global grad norm, clipping to ``grad_clip``, fp32
        moments with bias correction and decoupled weight decay. Updates
        ``params`` and the state's moments IN PLACE (the JAX package returns
        new trees) and returns ``(params, state, {"grad_norm", "lr"})``.

        The update is elementwise, so it runs on shards as it does on whole
        leaves. Only the norm needs the whole leaves: ``sq_reduce`` maps the
        leaves' sums of squares (in leaf order) to the whole leaves' (the
        sharded step sums each over the axes that shard its leaf); the norm
        adds them in leaf order."""
        ps, gs = tree_leaves(params), tree_leaves(grads)
        ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
        with torch.no_grad():
            sq = [torch.sum(torch.square(g.float())) for g in gs]
            if sq_reduce is not None:
                sq = sq_reduce(sq)
            gnorm = torch.sqrt(sum(sq))
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            step = state.step + 1
            lr = self.schedule(step)
            b1c = 1.0 - self.b1 ** step.float()
            b2c = 1.0 - self.b2 ** step.float()
            for p, g, m, v in zip(ps, gs, ms, vs):
                # the JAX package's expressions, op for op, in two fp32
                # buffers of the leaf's (block's) size and p's fp32 copy:
                # m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
                # delta = m / b1c / (sqrt(v / b2c) + eps) + wd p;
                # p = p - lr delta
                g = g.float() * scale
                tmp = torch.mul(g, 1.0 - self.b1)
                m.mul_(self.b1).add_(tmp)
                torch.mul(g, 1.0 - self.b2, out=tmp).mul_(g)
                v.mul_(self.b2).add_(tmp)
                torch.div(v, b2c, out=tmp).sqrt_().add_(self.eps)
                delta = torch.div(m, b1c, out=g).div_(tmp)
                p32 = p.float()
                delta.add_(torch.mul(p32, self.weight_decay, out=tmp))
                p.copy_(torch.sub(p32, torch.mul(delta, lr, out=tmp), out=tmp))
                del g, tmp, delta, p32
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
            "grad_norm": gnorm, "lr": lr}
