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
from .sharding import NO_SPLIT, model_split

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


def _project_qkv(x: Tensor, p: Dict[str, Tensor], cfg: ModelConfig, tp=NO_SPLIT,
                 all_kv: bool = False):
    """q of this rank's q heads (all of them unless the spec split ``wq``),
    the k and v heads they read (every kv head of a replicated ``wk`` with
    ``all_kv``), and the offset of its first q head in the expansion of
    those (``_expand_kv``). Under a split (``tp``) x enters it, and so do
    the per-head q and k norms."""
    B, S, _ = x.shape
    x = tp.enter(x)
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    hl = q.shape[-1] // cfg.head_dim
    q = q.reshape(B, S, hl, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, tp.enter(p["q_norm"]), cfg.norm_eps)
    k, v, off = _project_kv(x, p, cfg, tp, hl, all_kv=all_kv)
    return q, k, v, off


def _head_split(shard, cfg: ModelConfig, hl: int):
    """The split that ``hl`` q heads a rank run under: the sharded step's
    when the spec split them, else none (replicated heads compute alike on
    every ``model`` rank, so no gradient is summed over it)."""
    return model_split(shard) if hl < cfg.n_heads else NO_SPLIT


def _project_kv(src: Tensor, p: Dict[str, Tensor], cfg: ModelConfig, tp, hl: int,
                cross: bool = False, all_kv: bool = False) -> Tuple[Tensor, Tensor, int]:
    """The k and v heads that this rank's ``hl`` q heads read, from ``src``
    (already through ``tp.enter``), and the offset of its first q head in
    their expansion. Split kv heads (``wk`` by columns) are this rank's
    own; replicated ones enter the split block (their gradient is this
    rank's part) and only the needed heads are computed (all of them, and
    offset 0, without a split), or all of them with ``all_kv`` (the
    serving step's cache holds every kv head). Cross-attention (``cross``)
    takes no bias and no k norm."""
    hd, rep = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    kvl = p["wk"].shape[-1] // hd
    wk, wv = p["wk"], p["wv"]
    bk, bv = (p["bk"], p["bv"]) if cfg.qkv_bias and not cross else (None, None)
    off = 0
    if kvl == cfg.n_kv_heads:  # replicated: the kv heads of q heads [q0, q0 + hl)
        q0 = tp.coord * hl
        kv0, kv1 = (0, cfg.n_kv_heads) if all_kv else (q0 // rep, (q0 + hl - 1) // rep + 1)
        off = q0 - kv0 * rep
        cols = slice(kv0 * hd, kv1 * hd)
        wk, wv = tp.enter(wk)[:, cols], tp.enter(wv)[:, cols]
        if bk is not None:
            bk, bv = tp.enter(bk)[cols], tp.enter(bv)[cols]
        kvl = kv1 - kv0
    k, v = _matmul(src, wk), _matmul(src, wv)
    if bk is not None:
        k, v = k + bk, v + bv
    B, S = src.shape[:2]
    k, v = k.reshape(B, S, kvl, hd), v.reshape(B, S, kvl, hd)
    if cfg.qk_norm and not cross:
        k = rms_norm(k, tp.enter(p["k_norm"]), cfg.norm_eps)
    return k, v, off


def _expand_kv(k: Tensor, rep: int, hl: Optional[int] = None, off: int = 0) -> Tensor:
    """(B, S, KV, hd) -> (B, S, KV rep, hd) by repeating each kv head
    ``rep`` times; with ``hl``, the ``hl`` heads of that from head ``off``
    (the q heads of this rank)."""
    k = torch.repeat_interleave(k, rep, dim=2) if rep > 1 else k
    if hl is not None and (off or k.shape[2] != hl):
        k = k.narrow(2, off, hl)
    return k


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
    shard=None,
):
    """Full-sequence attention for prefill and the forward pass, causal over
    the whole (possibly right-padded) sequence. ``return_kv`` additionally
    returns the post-RoPE (KV-head) k/v for the decode cache.

    Under the sharded step (``shard``) q heads split over ``model`` (``wq``
    and ``bq`` by columns, ``wo`` by rows) run this rank's heads: its own
    kv heads when the spec splits them too, else the replicated ones those
    heads read (their k and v computed here, their gradient this rank's
    part, completed by ``enter``). One psum closes the block. Unsplit
    heads run as without a shard. Under the serving step
    (``shard.serving``) the returned k/v are what this rank's decode cache
    keeps: every kv head of a replicated ``wk``, at its block of
    ``head_dim`` where the cache splits it."""
    B, S, _ = x.shape
    if real_length(positions) < S and not causal:
        raise ValueError(
            "non-causal attention over pad positions needs a key mask, which the "
            "kernel does not take: run it at exact length"
        )
    hl = p["wq"].shape[-1] // cfg.head_dim
    tp = _head_split(shard, cfg, hl)
    q, kkv, vkv, off = _project_qkv(x, p, cfg, tp, all_kv=shard is not None and shard.serving)
    if cfg.rope_theta > 0:
        index = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, index, cfg.rope_theta)
        kkv = apply_rope(kkv, index, cfg.rope_theta)
    rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _expand_kv(kkv, rep, hl, off), _expand_kv(vkv, rep, hl, off)
    window = cfg.window if (is_local and cfg.window) else 0
    out = _attend(q, k, v, causal, window)
    out = tp.leave(out.reshape(B, S, hl * cfg.head_dim) @ p["wo"])
    if return_kv:
        if shard is not None and shard.serving and shard.hd_split:
            # the cache keeps this rank's block of head_dim: a copy, so that
            # the whole k and v are freed with the layer
            d0, n = shard.hd_block(cfg.head_dim)
            kkv, vkv = kkv.narrow(-1, d0, n).contiguous(), vkv.narrow(-1, d0, n).contiguous()
        return out, (kkv, vkv)
    return out


def cross_kv(enc: Tensor, p: Dict[str, Tensor], cfg: ModelConfig,
             shard=None, hl: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """One cross-attention layer's k and v of the encoder states (B, F, d),
    expanded to (B, F, H, hd), in the dtype JAX promotes ``enc @ wk`` to:
    what prefill computes for attention and keeps in ``DecodeCache.cross``.
    Under the sharded step, ``hl`` q heads a rank (fewer than H where the
    spec split ``wq``): the k and v of this rank's heads (the encoder
    states enter the split)."""
    hl = cfg.n_heads if hl is None else hl
    tp = _head_split(shard, cfg, hl)
    k, v, off = _project_kv(tp.enter(enc), p, cfg, tp, hl, cross=True)
    rep = cfg.n_heads // cfg.n_kv_heads
    return _expand_kv(k, rep, hl, off), _expand_kv(v, rep, hl, off)


def cross_cache_kv(enc: Tensor, p: Dict[str, Tensor], cfg: ModelConfig,
                   shard=None) -> Tuple[Tensor, Tensor]:
    """Every head's cross k and v (B, F, H, hd) of the encoder states, for
    the serving step's cross cache (split only like the batch, as JAX's dry
    run says): ``wk`` and ``wv`` gathered whole over ``model`` first where
    the spec split them (a weight, not the cache), then ``cross_kv``."""
    wk, wv = p["wk"], p["wv"]
    if wk.shape[-1] != cfg.n_kv_heads * cfg.head_dim:
        split = model_split(shard)
        wk, wv = split.gather(wk, -1), split.gather(wv, -1)
    return cross_kv(enc, {"wk": wk, "wv": wv}, cfg)


def cross_attend(x: Tensor, k: Tensor, v: Tensor, p: Dict[str, Tensor],
                 cfg: ModelConfig, shard=None) -> Tensor:
    """Queries of the decoder stream x (B, S, d) against the expanded
    encoder k/v (B, F, H, hd), non-causal, through K3 on the card. As in
    the JAX package the scores take the promoted dtype of q and k (bf16
    queries against fp32 keys: fp32) and the output q's dtype. Split heads
    (``shard``) run this rank's and one psum closes the block."""
    B, S, _ = x.shape
    hl = p["wq"].shape[-1] // cfg.head_dim
    tp = _head_split(shard, cfg, hl)
    q = _matmul(tp.enter(x), p["wq"]).reshape(B, S, hl, cfg.head_dim)
    dt = torch.promote_types(q.dtype, k.dtype)
    out = _attend(q.to(dt), k.to(dt), v.to(dt), causal=False).to(q.dtype)
    return tp.leave(_matmul(out.reshape(B, S, hl * cfg.head_dim), p["wo"]))


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
    shard=None,
) -> Dict[str, Tensor]:
    """Assemble a decode cache from prefill k/v, with ring placement for
    local (sliding-window) layers.

    Real entries keep the slot == position layout the decode writer
    assumes (a local layer: slot == position % window, the last ``window``
    real entries kept); pad entries (position -1) land with ``pos = -1``,
    so ``attention_decode`` masks them.

    Under the serving step (``shard``, a ``sharding.ServeSharding``) k and
    v are this rank's rows, kv heads and block of ``head_dim``, as
    ``attention_train`` returns them there, and the cache is this rank's
    block of the whole: its slots cut to its block where the batch axes
    split the sequence."""
    cache = _cache_from_kv(cfg, k, v, is_local, max_len, positions)
    if shard is None or shard.seq_parts == 1:
        return cache
    s0, n = shard.seq_block(cache["pos"].shape[1])
    return {key: t.narrow(1, s0, n).clone() for key, t in cache.items()}


def _cache_from_kv(cfg, k, v, is_local, max_len, positions):
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
    shard=None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode; ``position`` is a scalar or per-row ``(B,)``.
    Writes land at ``slot == position`` per row (a local layer's ring:
    ``position % size``), IN PLACE in ``cache`` (the JAX package returns
    updated copies); the same dict comes back.

    Under the serving step (``shard``, a ``sharding.ServeSharding``) x is
    this rank's rows and ``cache`` this rank's block in the layout of
    ``decode_cache_pspec``; a rank attends over the cache it holds, and no
    collective moves a cache block:

      * kv heads split over ``model``: this rank's kv heads are those its q
        heads read; one psum closes ``wo``'s rows, as in prefill;
      * ``head_dim`` split over ``model`` (the kv heads do not divide): the
        rank holds every kv head at its block of ``hd``. k is roped whole
        (RoPE rotates pairs across blocks) from the replicated ``wk`` and
        cut to the block; q of every head, gathered over ``model`` where
        ``wq`` splits the heads, is cut likewise. The scores are partial
        sums over the blocks: one psum of the (B, H, S) fp32 scores, the
        softmax on every rank, then each rank's block of the output,
        gathered along ``hd``, into ``wo`` (its rows of this rank's heads
        and a psum, or whole where ``wq`` is replicated);
      * the slots split over the batch axes (B = 1): the new token's k/v is
        written only by the rank whose block holds its slot; each rank's
        scores over its slots are combined flash-decoding style: the
        ``pmax`` of the row max, then one psum of the exp-sums and the
        weighted v.

    On one position this runs today's ops."""
    B = x.shape[0]
    hd = cfg.head_dim
    local = bool(is_local and cfg.window)
    hl = p["wq"].shape[-1] // hd
    tp = _head_split(shard, cfg, hl)
    split = model_split(shard)
    rep = cfg.n_heads // cfg.n_kv_heads
    all_kv = cache["k"].shape[2] == cfg.n_kv_heads  # the cache holds every kv head
    q, k, v, off = _project_qkv(x, p, cfg, tp, all_kv=all_kv)  # (B,1,hl,hd), (B,1,KV,hd)
    pos_v = torch.broadcast_to(position, (B,)).long()
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos_v[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_v[:, None], cfg.rope_theta)
    hd_split = shard is not None and shard.hd_split
    if hd_split:  # this rank's block of every head's q and of the new k/v
        d0, hdc = shard.hd_block(hd)
        if hl < cfg.n_heads:
            q = split.gather(q, 2)
        q, k, v = q.narrow(-1, d0, hdc), k.narrow(-1, d0, hdc), v.narrow(-1, d0, hdc)

    size = cache["k"].shape[1]
    seq_parts = 1 if shard is None else shard.seq_parts
    total = size * seq_parts
    slot = torch.clamp(pos_v % total if local else pos_v, max=total - 1)
    rows = torch.arange(B, device=x.device)
    if seq_parts == 1:
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
        cache["pos"][rows, slot] = pos_v.to(torch.int32)
    else:  # only the rank whose block holds the slot writes it
        s0, _ = shard.seq_block(total)
        at = slot - s0
        mine = (at >= 0) & (at < size)
        at = at.clamp(0, size - 1)
        for key, new in (("k", k[:, 0]), ("v", v[:, 0]), ("pos", pos_v.to(torch.int32))):
            old = cache[key][rows, at]
            m = mine.view((B,) + (1,) * (new.dim() - 1))
            cache[key][rows, at] = torch.where(m, new, old)

    heads = cfg.n_heads if hd_split else hl
    q0 = 0 if hd_split else off
    kk = _expand_kv(cache["k"], rep, heads, q0).float()  # (B, size, heads, hd or block)
    vv = _expand_kv(cache["v"], rep, heads, q0).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk)
    if hd_split:  # the blocks' partial sums
        s = split.leave(s)
    s = s * (1.0 / math.sqrt(hd))
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos_v[:, None])
    if local:
        valid &= cpos > pos_v[:, None] - cfg.window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if seq_parts == 1:
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vv)
    else:  # flash-decoding combine over the blocks of slots
        m = shard.seq_max(s.amax(dim=-1, keepdim=True))
        e = torch.exp(s - m)
        part = torch.cat([torch.einsum("bhqk,bkhd->bqhd", e, vv),
                          e.sum(dim=-1).permute(0, 2, 1)[..., None]], dim=-1)
        part = shard.seq_sum(part)
        out = part[..., :-1] / part[..., -1:]
    out = out.to(x.dtype)
    if hd_split:  # every head whole, then this rank's heads
        out = split.gather(out, -1)
        if hl < cfg.n_heads:
            out = out.narrow(2, tp.coord * hl, hl)
    out = out.reshape(B, 1, hl * hd)
    return tp.leave(out @ p["wo"]), cache


def cross_attention_decode(
    x: Tensor,  # (B, 1, d)
    enc_kv: Tuple[Tensor, Tensor],  # the cached expanded (B, F, H, hd) k, v
    p: Dict[str, Tensor],
    cfg: ModelConfig,
    shard=None,
) -> Tensor:
    """One token's cross-attention against the cached encoder k/v, plain
    torch in fp32 as in the JAX package; the output in x's dtype. Under
    the serving step the cross cache holds every head of this rank's rows
    (split like the batch, as JAX's dry run says): q heads split over
    ``model`` read their own heads of it, and one psum closes ``wo``."""
    B = x.shape[0]
    hd = cfg.head_dim
    hl = p["wq"].shape[-1] // hd
    tp = _head_split(shard, cfg, hl)
    q = _matmul(tp.enter(x), p["wq"]).reshape(B, 1, hl, hd)
    k, v = enc_kv
    if hl < k.shape[2]:
        k, v = k.narrow(2, tp.coord * hl, hl), v.narrow(2, tp.coord * hl, hl)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return tp.leave(_matmul(out.to(x.dtype).reshape(B, 1, hl * hd), p["wo"]))
