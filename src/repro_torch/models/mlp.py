"""Feed-forward blocks: dense (SwiGLU / squared-ReLU / GELU) and the
Mixture-of-Experts with capacity-based dispatch.

The MoE is the JAX package's sort-free cumsum dispatch: a token's slot in
each expert's buffer is a running count over the tokens of its group (a
batch row), int32 slot maps say which token fills each (expert, slot),
gathers move the d-vectors into an expert-major (E, B, C, d) buffer, every
expert runs as one batched product over its C slots, and a gather brings
the outputs back weighted by the renormalised top-k gates. Tokens past an
expert's capacity are dropped (Switch-style) and counted in the aux
metrics. The expert products are plain ``torch.matmul`` calls, as the JAX
package leaves its einsums to XLA outside any Pallas kernel.

Dispatch and combine are the JAX package's custom-VJP gathers
(``_moe_dispatch`` / ``_moe_combine``) as ``torch.autograd.Function``s:
the (token, k) -> (expert, slot) assignment is a partial bijection, so the
backward of each gather is a gather too (through the other slot map),
not the scatter-add autograd would make of an indexing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..configs.base import ModelConfig
from .common import activation, dense_init

Tensor = torch.Tensor


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict[str, Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, f), dtype),
            "w_up": dense_init(gen, (d, f), dtype),
            "w_down": dense_init(gen, (f, d), dtype),
        }
    return {
        "w_up": dense_init(gen, (d, f), dtype),
        "w_down": dense_init(gen, (f, d), dtype),
    }


def mlp(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = activation(cfg.act)(x @ p["w_up"])
    return h @ p["w_down"]


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict[str, Tensor]:
    """The router in fp32 (std 0.02), the experts' (E, d, f) / (E, f, d)
    weights (fan-in d / f) and, with ``n_shared_experts``, one shared
    SwiGLU of width ``f * n_shared_experts``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (d, e), torch.float32, scale=0.02),
        "w_gate": dense_init(gen, (e, d, f), dtype),
        "w_up": dense_init(gen, (e, d, f), dtype),
        "w_down": dense_init(gen, (e, f, d), dtype),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_gate"] = dense_init(gen, (d, fs), dtype)
        p["shared_up"] = dense_init(gen, (d, fs), dtype)
        p["shared_down"] = dense_init(gen, (fs, d), dtype)
    return p


def _capacity(group_tokens: int, cfg: ModelConfig) -> int:
    """Per-group expert capacity: ``S K cf / E`` rounded up to a multiple
    of 8, at least 8 and at most ``S K``. A group is a batch row, so C
    follows the row's (bucket) length: a decode step (S = 1) gets 8."""
    c = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    c = max(8, ((c + 7) // 8) * 8)
    return min(c, group_tokens * cfg.top_k)


def _top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, ties to the lower index (a stable descending sort keeps equal
    values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoeDispatch(torch.autograd.Function):
    """buf (E, B, C, d) of x (B, S, d): slot (e, b, c) holds token
    ``slot_src[b, e, c]`` of row b, zeros where it is S (empty). The
    backward gathers each (token, k)'s slot gradient (``e_flat``,
    ``pos_clip``; dropped entries point at the zero column C) and sums over
    k. The JAX package's ``_moe_dispatch``, expert-major."""

    @staticmethod
    def forward(ctx, x, slot_src, e_flat, pos_clip):
        B, S, d = x.shape
        x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
        rows = torch.arange(B, device=x.device)
        ctx.save_for_backward(e_flat, pos_clip)
        ctx.S = S
        # a dense expert-major index: the gather's output layout follows its
        # index's on some devices, so every device writes (E, B, C, d) dense
        return x_pad[rows[None, :, None], slot_src.transpose(0, 1).contiguous()]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        e_flat, pos_clip = ctx.saved_tensors
        E, B, C, d = g.shape
        K = e_flat.shape[1] // ctx.S
        g_pad = torch.cat([g, g.new_zeros((E, B, 1, d))], dim=2)
        rows = torch.arange(B, device=g.device)
        gx = g_pad[e_flat, rows[:, None], pos_clip]  # (B, S K, d)
        return gx.view(B, ctx.S, K, d).sum(dim=2), None, None, None


class MoeCombine(torch.autograd.Function):
    """y_flat (B, S K, d) of out_buf (E, B, C, d): (token, k) takes its
    slot's output, zeros where it was dropped (``pos_clip`` == C). The
    backward gathers each slot's gradient from the (token, k) that filled
    it (``slot_sk``, S K where empty). The JAX package's ``_moe_combine``."""

    @staticmethod
    def forward(ctx, out_buf, e_flat, pos_clip, slot_sk):
        C = out_buf.shape[2]
        rows = torch.arange(out_buf.shape[1], device=out_buf.device)
        ctx.save_for_backward(slot_sk)
        # the gather from the zero-padded buffer, without copying the buffer
        # (E C slots can far outnumber the S K entries, as in a decode step)
        y = out_buf[e_flat, rows[:, None], pos_clip.clamp(max=C - 1)]
        return y.masked_fill_((pos_clip == C)[..., None], 0)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (slot_sk,) = ctx.saved_tensors
        B, SK, d = g.shape
        g_pad = torch.cat([g, g.new_zeros((B, 1, d))], dim=1)
        rows = torch.arange(B, device=g.device)
        idx = slot_sk.transpose(0, 1).contiguous()  # dense, as in MoeDispatch
        return g_pad[rows[None, :, None], idx], None, None, None


def moe_ffn(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig,
            shard=None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, d). Returns (out (B, S, d), aux) with aux's ``aux_loss``
    (Switch load balance), ``drop_frac`` and ``router_entropy``, and the
    routing: each token's experts ``expert_idx`` (B, S, K).

    Under the sharded train step, ``shard`` (``sharding.StepSharding``)
    says that x is this rank's rows of a batch split over
    ``shard.batch_positions`` ranks. The aux loss is then this rank's term
    of the whole batch's ``E sum_e f_e p_e``: f_e (no gradient) from the
    expert counts summed over the batch axes, and this rank's probabilities
    summed over its rows, both over the whole batch's size. The terms sum
    over the ranks to the batch's aux loss, and their gradients to its
    gradient. Capacity and drops need nothing: a group is a batch row."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(S, cfg)
    dev = x.device

    logits = x.float() @ p["router"]  # (B, S, E), fp32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, K)  # (B, S, K)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # each (token, k)'s expert one-hot over the token-major order, and its
    # running count per group: the same ops on every device (F.one_hot
    # reads the ids' range on the host on the CPU, and bincount's output
    # size depends on the data), so a meta trace counts what the card runs
    e_flat = idx.reshape(B, S * K)
    oh = (e_flat[..., None] == torch.arange(E, device=dev)).long()  # (B, SK, E)
    run = torch.cumsum(oh, dim=1)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e; every expert's
    # count (bincount with minlength E) from the groups' running counts
    counts = run[:, -1].sum(dim=0).float()
    if shard is None or shard.batch_positions == 1:
        me = probs.mean(dim=(0, 1))
        fe = counts / (B * S * K)
    else:
        rows = B * shard.batch_positions
        me = probs.sum(dim=(0, 1)) / (rows * S)
        fe = shard.psum_batch(counts) / (rows * S * K)
    aux_loss = E * torch.sum(fe * me)

    # slots within each group's expert buffers: an exclusive running count
    # over the token-major (token, k) order
    pos = (run - oh).gather(2, e_flat[..., None])[..., 0]
    del oh, run
    dropped = pos >= C
    pos_clip = torch.where(dropped, torch.full_like(pos, C), pos)

    # int slot maps: the source token and the source (token, k) of each
    # (expert, slot), S and S K where empty; dropped entries land in column
    # C, which is cut off
    sk = torch.arange(S * K, device=dev).expand(B, S * K)

    def slot_map(fill, vals):
        m = torch.full((B, E * (C + 1)), fill, dtype=torch.long, device=dev)
        m.scatter_(1, e_flat * (C + 1) + pos_clip, vals)
        return m.view(B, E, C + 1)[:, :, :C]

    slot_src = slot_map(S, sk // K)
    slot_sk = slot_map(S * K, sk)
    buf = MoeDispatch.apply(x, slot_src, e_flat, pos_clip)  # (E, B, C, d)

    # every expert over its C slots of every group, one batched product
    xb = buf.reshape(E, B * C, d)
    if cfg.act == "swiglu":
        h = F.silu(torch.matmul(xb, p["w_gate"])) * torch.matmul(xb, p["w_up"])
    else:
        h = activation(cfg.act)(torch.matmul(xb, p["w_up"]))
    out_buf = torch.matmul(h, p["w_down"]).view(E, B, C, d)

    # combine: each (token, k) gathers its slot's output (zero where
    # dropped), weighted by its renormalised gate
    y_flat = MoeCombine.apply(out_buf, e_flat, pos_clip, slot_sk)  # (B, SK, d)
    w = (gates.reshape(B, S * K) * (~dropped)).to(x.dtype)
    y = (y_flat * w[..., None]).reshape(B, S, K, d).sum(dim=2)

    if cfg.n_shared_experts:
        sh = F.silu(x @ p["shared_gate"]) * (x @ p["shared_up"])
        y = y + sh @ p["shared_down"]

    aux = {
        "aux_loss": aux_loss,
        "drop_frac": dropped.float().mean(),
        "router_entropy": -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), dim=-1)),
        "expert_idx": idx,
    }
    return y, aux
