"""Attention: GQA with RoPE, causal / sliding-window prefill through the
flash-attention kernel, and KV-cache decode with per-row positions and ring
buffers for local layers.

Prefill runs ``kernels.flash.ops.flash_attention_bshd``: on CUDA tensors
the Hopper kernel, on CPU tensors its plain version. Its mask is by index.
The JAX package masks by position (``chunked_attention``), and the two
agree for the positions a prefill has: ``arange(S)``, or ``arange(L)``
followed by ``-1`` pad entries (a right-padded bucket). Pad keys sit at
indices at or past L, beyond every real query's diagonal, so the causal
mask (and the window, relative to the same index) already hides them from
every real row; pad rows produce values nobody reads (their logits are not
taken and their cache slots carry ``pos = -1``). RoPE runs at the index,
which is the position on every real row and keeps pad rows finite. Decode
is plain torch, as it is in the JAX package.

Non-causal calls (the encoder, cross-attention) have no pad keys to hide:
the encoder's frames are all real and the encoder-decoder prefills at
exact length. On the card they run K3 at their whole length (the kernel
masks its ragged last key tile); on the CPU the plain version at their
whole length, since ``flash_attention_bshd`` pads keys to the block and
only a causal mask hides such pads. Cross-attention's decode is plain
torch against the cached (B, F, H, hd) encoder k/v.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.flash.ops import flash_attention_bshd
from ..kernels.flash.ref import attention_ref
from ..roofline import analysis as _cost
from .common import apply_rope, dense_init, rms_norm

Tensor = torch.Tensor

NEG_INF = -1e30


def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict[str, Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype),
    }
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=gen.device)
    if cfg.qkv_bias:
        p["bq"] = zeros(cfg.n_heads * hd)
        p["bk"] = zeros(cfg.n_kv_heads * hd)
        p["bv"] = zeros(cfg.n_kv_heads * hd)
    if cfg.qk_norm:
        p["q_norm"] = zeros(hd)
        p["k_norm"] = zeros(hd)
    return p


def _project_qkv(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _expand_kv(k: Tensor, n_heads: int) -> Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each kv head."""
    rep = n_heads // k.shape[2]
    return torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k


def _matmul(a: Tensor, b: Tensor) -> Tensor:
    """a @ b in the dtype JAX's type promotion gives the pair (torch's
    matmul takes one dtype): fp32 encoder states against bf16 weights
    multiply in fp32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _attend(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int = 0) -> Tensor:
    """Attention in the model layout (B, S, H, hd) through K3 on the card.
    A non-causal call on the CPU runs the plain version at its whole length
    (``flash_attention_bshd`` would pad the keys, which only a causal mask
    hides); under a cost counter it goes through the dispatcher, which
    counts it as K3 and runs it so."""
    if q.device.type == "cpu" and not causal and _cost.ACTIVE is None:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), False,
                            window)
        return out.transpose(1, 2)
    return flash_attention_bshd(q, k, v, causal, window)


def real_length(positions: Tensor) -> int:
    """L of a prefill's positions ``arange(L)`` followed by ``-1``s (a
    right-padded bucket); raises on any other pattern. A CPU tensor is read
    in place; a CUDA tensor is copied to the host first (a synchronization),
    so the port's own callers build positions on the CPU."""
    p = positions.detach().reshape(-1).cpu()
    S = p.shape[0]
    L = int((p >= 0).sum())
    ok = torch.equal(p[:L], torch.arange(L, dtype=p.dtype)) and bool((p[L:] == -1).all())
    if not ok:
        raise ValueError(
            f"positions must be arange(L) followed by -1 pad entries (right-padded), "
            f"got {p[:8].tolist()}... of length {S}"
        )
    return L


def attention_train(
    x: Tensor,
    p: Dict[str, Tensor],
    cfg: ModelConfig,
    positions: Tensor,  # (S,): arange(L) then -1s (best on the CPU, see real_length)
    is_local: bool = False,
    causal: bool = True,
    return_kv: bool = False,
):
    """Full-sequence attention for prefill and the forward pass, causal over
    the whole (possibly right-padded) sequence. ``return_kv`` additionally
    returns the post-RoPE (KV-head) k/v for the decode cache."""
    B, S, _ = x.shape
    if real_length(positions) < S and not causal:
        raise ValueError(
            "non-causal attention over pad positions needs a key mask, which the "
            "kernel does not take: run it at exact length"
        )
    q, kkv, vkv = _project_qkv(x, p, cfg)
    if cfg.rope_theta > 0:
        index = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, index, cfg.rope_theta)
        kkv = apply_rope(kkv, index, cfg.rope_theta)
    k = _expand_kv(kkv, cfg.n_heads)
    v = _expand_kv(vkv, cfg.n_heads)
    window = cfg.window if (is_local and cfg.window) else 0
    out = _attend(q, k, v, causal, window)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_kv:
        return out, (kkv, vkv)
    return out


def cross_kv(enc: Tensor, p: Dict[str, Tensor], cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """One cross-attention layer's k and v of the encoder states (B, F, d),
    expanded to (B, F, H, hd), in the dtype JAX promotes ``enc @ wk`` to:
    what prefill computes for attention and keeps in ``DecodeCache.cross``."""
    B, F_ = enc.shape[:2]
    hd = cfg.head_dim
    k = _matmul(enc, p["wk"]).reshape(B, F_, cfg.n_kv_heads, hd)
    v = _matmul(enc, p["wv"]).reshape(B, F_, cfg.n_kv_heads, hd)
    return _expand_kv(k, cfg.n_heads), _expand_kv(v, cfg.n_heads)


def cross_attend(x: Tensor, k: Tensor, v: Tensor, p: Dict[str, Tensor],
                 cfg: ModelConfig) -> Tensor:
    """Queries of the decoder stream x (B, S, d) against the expanded
    encoder k/v (B, F, H, hd), non-causal, through K3 on the card. As in
    the JAX package the scores take the promoted dtype of q and k (bf16
    queries against fp32 keys: fp32) and the output q's dtype."""
    B, S, _ = x.shape
    q = _matmul(x, p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    dt = torch.promote_types(q.dtype, k.dtype)
    out = _attend(q.to(dt), k.to(dt), v.to(dt), causal=False).to(q.dtype)
    return _matmul(out.reshape(B, S, cfg.n_heads * cfg.head_dim), p["wo"])


def cross_attention_train(x: Tensor, enc: Tensor, p: Dict[str, Tensor],
                          cfg: ModelConfig) -> Tensor:
    """Cross-attention of the decoder stream x (B, S, d) over the encoder
    states enc (B, F, d)."""
    return cross_attend(x, *cross_kv(enc, p, cfg), p, cfg)


def cache_from_kv(
    cfg: ModelConfig,
    k: Tensor,  # (B, S, KV, hd) post-rope
    v: Tensor,
    is_local: bool,
    max_len: int,
    positions: Optional[Tensor] = None,  # (S,): arange(L) then -1s; None = arange(S)
) -> Dict[str, Tensor]:
    """Assemble a decode cache from prefill k/v, with ring placement for
    local (sliding-window) layers.

    Real entries keep the slot == position layout the decode writer
    assumes (a local layer: slot == position % window, the last ``window``
    real entries kept); pad entries (position -1) land with ``pos = -1``,
    so ``attention_decode`` masks them."""
    B, S = k.shape[:2]
    L = S if positions is None else real_length(positions)
    dev = k.device
    if is_local and cfg.window:
        W = min(cfg.window, max_len)
        kept = torch.arange(max(0, L - W), L, device=dev)
        slots = kept % W
        ck = k.new_zeros((B, W) + tuple(k.shape[2:]))
        cv = v.new_zeros((B, W) + tuple(v.shape[2:]))
        cpos = torch.full((B, W), -1, dtype=torch.int32, device=dev)
        ck[:, slots] = k[:, kept]
        cv[:, slots] = v[:, kept]
        cpos[:, slots] = kept.to(torch.int32)
        return {"k": ck, "v": cv, "pos": cpos}
    ck = k.new_zeros((B, max_len) + tuple(k.shape[2:]))
    cv = v.new_zeros((B, max_len) + tuple(v.shape[2:]))
    ck[:, :S] = k
    cv[:, :S] = v
    cpos = torch.full((B, max_len), -1, dtype=torch.int32, device=dev)
    cpos[:, :L] = torch.arange(L, dtype=torch.int32, device=dev)
    return {"k": ck, "v": cv, "pos": cpos}


# ---------------------------------------------------------------------------
# decode (one token) with KV cache
# ---------------------------------------------------------------------------
def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, is_local: bool, dtype, device
) -> Dict[str, Tensor]:
    """Cache for one attention layer. Local layers get a ring buffer of
    ``min(window, max_len)`` slots."""
    size = min(cfg.window, max_len) if (is_local and cfg.window) else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position of each slot (for masking); -1 = empty
        "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),
    }


def attention_decode(
    x: Tensor,  # (B, 1, d) current token
    cache: Dict[str, Tensor],
    p: Dict[str, Tensor],
    cfg: ModelConfig,
    position: Tensor,  # scalar OR (B,) int — current absolute position(s)
    is_local: bool,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode; ``position`` is a scalar or per-row ``(B,)``.
    Writes land at ``slot == position`` per row (a local layer's ring:
    ``position % size``), IN PLACE in ``cache`` (the JAX package returns
    updated copies); the same dict comes back."""
    B = x.shape[0]
    hd = cfg.head_dim
    local = bool(is_local and cfg.window)
    q, k, v = _project_qkv(x, p, cfg)  # (B,1,H,hd), (B,1,KV,hd)
    pos_v = torch.broadcast_to(position, (B,)).long()
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos_v[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_v[:, None], cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = torch.clamp(pos_v % size if local else pos_v, max=size - 1)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    cache["pos"][rows, slot] = pos_v.to(torch.int32)

    kk = _expand_kv(cache["k"], cfg.n_heads).float()  # (B, size, H, hd)
    vv = _expand_kv(cache["v"], cfg.n_heads).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * (1.0 / math.sqrt(hd))
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos_v[:, None])
    if local:
        valid &= cpos > pos_v[:, None] - cfg.window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vv)
    out = out.to(x.dtype).reshape(B, 1, cfg.n_heads * hd)
    return out @ p["wo"], cache


def cross_attention_decode(
    x: Tensor,  # (B, 1, d)
    enc_kv: Tuple[Tensor, Tensor],  # the cached expanded (B, F, H, hd) k, v
    p: Dict[str, Tensor],
    cfg: ModelConfig,
) -> Tensor:
    """One token's cross-attention against the cached encoder k/v, plain
    torch in fp32 as in the JAX package; the output in x's dtype."""
    B = x.shape[0]
    hd = cfg.head_dim
    q = _matmul(x, p["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k, v = enc_kv
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return _matmul(out.to(x.dtype).reshape(B, 1, cfg.n_heads * hd), p["wo"])
