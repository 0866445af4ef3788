"""Feed-forward blocks: dense (SwiGLU / squared-ReLU / GELU) and the
Mixture-of-Experts with capacity-based dispatch.

The MoE is the JAX package's sort-free cumsum dispatch, forward only: a
token's slot in each expert's buffer is a running count over the tokens
of its group (a batch row), int32 slot maps say which token fills each
(expert, slot), gathers move the d-vectors into a (B, E, C, d) buffer,
every expert runs as one batched product over its C slots, and a gather
brings the outputs back weighted by the renormalised top-k gates. Tokens
past an expert's capacity are dropped (Switch-style) and counted in the
aux metrics. The expert products are plain ``torch.matmul`` calls, as the
JAX package leaves its einsums to XLA outside any Pallas kernel. The JAX
package's custom-VJP gathers (its backward) come with training.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def moe_ffn(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, S, d). Returns (out (B, S, d), aux) with aux's ``aux_loss``
    (Switch load balance), ``drop_frac`` and ``router_entropy``, and the
    routing: each token's experts ``expert_idx`` (B, S, K)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(S, cfg)
    dev = x.device

    logits = x.float() @ p["router"]  # (B, S, E), fp32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, K)  # (B, S, K)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    fe = torch.bincount(idx.reshape(-1), minlength=E).float() / (B * S * K)
    aux_loss = E * torch.sum(fe * me)

    # slots within each group's expert buffers: an exclusive running count
    # over the token-major (token, k) order
    e_flat = idx.reshape(B, S * K)
    oh = F.one_hot(e_flat, E)  # (B, SK, E)
    pos = (torch.cumsum(oh, dim=1) - oh).gather(2, e_flat[..., None])[..., 0]
    del oh
    dropped = pos >= C
    pos_clip = torch.where(dropped, torch.full_like(pos, C), pos)

    # int slot map: the source token of each (expert, slot), S where empty;
    # dropped entries land in column C, which is cut off
    src_tok = (torch.arange(S * K, device=dev) // K).expand(B, S * K)
    slot_src = torch.full((B, E * (C + 1)), S, dtype=torch.long, device=dev)
    slot_src.scatter_(1, e_flat * (C + 1) + pos_clip, src_tok)
    slot_src = slot_src.view(B, E, C + 1)[:, :, :C]
    rows = torch.arange(B, device=dev)
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    buf = x_pad[rows[:, None, None], slot_src]  # (B, E, C, d)

    # every expert over its C slots of every group, one batched product
    xb = buf.transpose(0, 1).reshape(E, B * C, d)
    if cfg.act == "swiglu":
        h = F.silu(torch.matmul(xb, p["w_gate"])) * torch.matmul(xb, p["w_up"])
    else:
        h = activation(cfg.act)(torch.matmul(xb, p["w_up"]))
    out_buf = torch.matmul(h, p["w_down"]).view(E, B, C, d)

    # combine: each (token, k) gathers its slot's output (zero where
    # dropped), weighted by its renormalised gate
    y_flat = out_buf[e_flat, rows[:, None], pos_clip.clamp(max=C - 1)]  # (B, SK, d)
    y_flat = torch.where(dropped[..., None], torch.zeros_like(y_flat), y_flat)
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
