"""The zamba2-style hybrid language model: Mamba2 layers with one shared
attention+MLP block applied after every ``hybrid_attn_every`` of them.

Entry points:
    init_params(cfg, seed, device)         -> param dict
    prefill(cfg, params, tokens)           -> (last_logits, DecodeCache)
    decode_step(cfg, params, token, cache) -> (logits, DecodeCache)

Params are a plain dict with the JAX package's pytree keys, the layer axis
stacked in front (``params["layers"]["ssm"]["w_z"]`` is (n_layers, d,
d_inner)), so a JAX pytree carries across leaf for leaf
(``convert.lm_params_from_reference``). The JAX package's ``lax.scan``
over layers is a Python loop here. Prefill goes through the two Hopper
kernels (the SSD chunk in every Mamba2 layer, flash attention in every
application of the shared block); decode is plain torch, as in the JAX
package, and updates the cache in place.

Not ported yet (later slices): the dense, MoE, pure-SSM, VLM and
encoder-decoder architectures, training (``forward_train``, ``loss_fn``),
and pad-masked bucketed prefill (``true_len``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.dmtrl import resolve_device
from . import attention as attn_mod
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import dense_init, dtype_of, embed_init, rms_norm

Tensor = torch.Tensor


def _require_hybrid(cfg: ModelConfig) -> None:
    if cfg.arch_type != "hybrid":
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r} is not ported yet (the port serves "
            "the hybrid architecture)"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _shared_mlp_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, act="swiglu")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters drawn on ``device`` from ``seed``, with the JAX
    package's shapes, dtypes and std rules (not its draws)."""
    _require_hybrid(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype_of(cfg.dtype)
    Vp, d, L = cfg.vocab_padded, cfg.d_model, cfg.n_layers
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (Vp, d), dtype),
        "final_norm": zeros(d),
        "lm_head": dense_init(gen, (d, Vp), dtype),
    }
    # the stacked layer axis is drawn layer by layer, then stacked
    per_layer = [ssm_mod.init_ssm_params(gen, cfg, dtype) for _ in range(L)]
    params["layers"] = {
        "ln1": zeros(L, d),
        "ssm": {k: torch.stack([lp[k] for lp in per_layer]) for k in per_layer[0]},
    }
    del per_layer
    params["shared"] = {
        "ln1": zeros(d),
        "attn": attn_mod.init_attn_params(gen, cfg, dtype),
        "ln2": zeros(d),
        "mlp": mlp_mod.init_mlp_params(gen, _shared_mlp_cfg(cfg), dtype),
    }
    return params


def _layer_params_at(params, i: int) -> Dict[str, Any]:
    lp = params["layers"]
    return {"ln1": lp["ln1"][i], "ssm": {k: v[i] for k, v in lp["ssm"].items()}}


# ---------------------------------------------------------------------------
# layer application (prefill)
# ---------------------------------------------------------------------------
def _ssm_block(cfg: ModelConfig, lp, h: Tensor):
    """(h + Mamba2(h), (state, conv_window))."""
    out, state, conv = ssm_mod.ssm_block_train(
        rms_norm(h, lp["ln1"], cfg.norm_eps), lp["ssm"], cfg
    )
    return h + out, (state, conv)


def _shared_block(cfg: ModelConfig, sp, h: Tensor, positions: Tensor):
    """(h after the shared attention + SwiGLU block, its post-RoPE (k, v))."""
    att, kv = attn_mod.attention_train(
        rms_norm(h, sp["ln1"], cfg.norm_eps), sp["attn"], cfg, positions, False,
        return_kv=True,
    )
    h = h + att
    h = h + mlp_mod.mlp(rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], _shared_mlp_cfg(cfg))
    return h, kv


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecodeCache:
    layers: List[Dict[str, Tensor]]  # per-layer ssm caches
    position: Tensor  # scalar int32 (B=1 prefill) or (B,) — next position to write
    shared: Optional[List[Dict[str, Tensor]]] = None  # shared-attn caches, one per period


def init_decode_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=None, device="cuda"
) -> DecodeCache:
    _require_hybrid(cfg)
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    layers = [ssm_mod.init_ssm_cache(cfg, batch, dtype, device) for _ in range(cfg.n_layers)]
    periods = cfg.n_layers // cfg.hybrid_attn_every
    shared = [
        attn_mod.init_kv_cache(cfg, batch, max_len, False, dtype, device)
        for _ in range(periods)
    ]
    return DecodeCache(layers, torch.zeros((), dtype=torch.int32, device=device), shared)


def decode_step(
    cfg: ModelConfig, params, token: Tensor, cache: DecodeCache
) -> Tuple[Tensor, DecodeCache]:
    """One-token decode. token: (B,) int. Returns (logits (B, Vp), cache).

    ``cache.position`` may be a scalar or a per-row ``(B,)`` vector. The
    layer caches are updated in place; the returned cache holds the same
    tensors and the advanced position."""
    _require_hybrid(cfg)
    pos = cache.position
    h = params["embed"][token.long()][:, None, :]  # (B, 1, d)
    period = cfg.hybrid_attn_every
    sp = params["shared"]
    for i in range(cfg.n_layers):
        lp = _layer_params_at(params, i)
        out, _ = ssm_mod.ssm_block_decode(
            rms_norm(h, lp["ln1"], cfg.norm_eps), cache.layers[i], lp["ssm"], cfg
        )
        h = h + out
        if (i + 1) % period == 0:  # the shared block after every period
            out, _ = attn_mod.attention_decode(
                rms_norm(h, sp["ln1"], cfg.norm_eps), cache.shared[(i + 1) // period - 1],
                sp["attn"], cfg, pos, False,
            )
            h = h + out
            h = h + mlp_mod.mlp(
                rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], _shared_mlp_cfg(cfg)
            )
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = (h @ params["lm_head"])[:, 0]
    return logits, DecodeCache(cache.layers, pos + 1, cache.shared)


def prefill(
    cfg: ModelConfig,
    params,
    tokens: Tensor,  # (B, S) int
    extra_len: int = 1024,
    true_len: Optional[Tensor] = None,
) -> Tuple[Tensor, DecodeCache]:
    """Run the full prompt; return last-position logits (B, Vp) and a FILLED
    cache (SSD final states and conv windows of every Mamba2 layer, the
    shared block's k/v of every period, slot == position) with room for
    ``extra_len`` more tokens. A hybrid's state scan cannot skip pad steps,
    so it prefills at exact length: ``true_len`` raises, as in the JAX
    package."""
    _require_hybrid(cfg)
    if true_len is not None:
        raise ValueError(
            "true_len (pad-masked bucketed prefill) is only supported for "
            f"attention architectures, not arch_type={cfg.arch_type!r}; "
            "prefill those at exact length"
        )
    B, S = tokens.shape
    max_len = S + extra_len
    h = params["embed"][tokens.long()]
    positions = torch.arange(S, device=h.device)
    every = cfg.hybrid_attn_every
    sp = params["shared"]
    layers: List[Dict[str, Tensor]] = []
    shared: List[Dict[str, Tensor]] = []
    for pi in range(cfg.n_layers // every):
        for li in range(every):
            h, (state, conv) = _ssm_block(cfg, _layer_params_at(params, pi * every + li), h)
            layers.append({"state": state, "conv": conv})
        h, (k, v) = _shared_block(cfg, sp, h, positions)
        shared.append(attn_mod.cache_from_kv(cfg, k, v, False, max_len))
    # only the last position's logits are returned, so only they are formed
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ params["lm_head"])[:, 0]
    position = torch.tensor(S, dtype=torch.int32, device=h.device)
    return logits, DecodeCache(layers, position, shared)
