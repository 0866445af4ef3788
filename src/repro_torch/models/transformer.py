"""Decoder-only language models of three families: dense (local/global
attention + MLP blocks: qwen1.5, nemotron-4, gemma3), pure SSM (Mamba2)
and the zamba2-style hybrid (Mamba2 layers with one shared attention+MLP
block applied after every ``hybrid_attn_every`` of them).

Entry points:
    init_params(cfg, seed, device)         -> param dict
    forward_train(cfg, params, tokens)     -> (logits, aux), forward only
    prefill(cfg, params, tokens)           -> (last_logits, DecodeCache)
    decode_step(cfg, params, token, cache) -> (logits, DecodeCache)

Params are a plain dict with the JAX package's pytree keys, the layer axis
stacked in front (``params["layers"]["attn"]["wq"]`` is (n_layers, d,
H hd)), so a JAX pytree carries across leaf for leaf
(``convert.lm_params_from_reference``). The JAX package's ``lax.scan``
over layers is a Python loop here. Prefill goes through the two Hopper
kernels (flash attention in every attention layer and every application
of the shared block, the SSD chunk in every Mamba2 layer); decode is plain
torch, as in the JAX package, and updates the cache in place.

Not ported yet (later slices): the MoE, VLM and encoder-decoder
architectures, and training (``loss_fn``; ``forward_train`` has no
backward pass on the card: the kernels have no backward kernels).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig
from ..core.dmtrl import resolve_device
from . import attention as attn_mod
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import dense_init, dtype_of, embed_init, rms_norm

Tensor = torch.Tensor

PORTED_ARCHS = ("dense", "ssm", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in PORTED_ARCHS or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r} ({cfg.name}) is not ported yet (the port "
            f"serves {', '.join(PORTED_ARCHS)} decoder-only architectures)"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _shared_mlp_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, act="swiglu")


def _init_one_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Dict[str, Any]:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    if cfg.arch_type in ("ssm", "hybrid"):
        return {"ln1": zeros(), "ssm": ssm_mod.init_ssm_params(gen, cfg, dtype)}
    return {
        "ln1": zeros(),
        "attn": attn_mod.init_attn_params(gen, cfg, dtype),
        "ln2": zeros(),
        "mlp": mlp_mod.init_mlp_params(gen, cfg, dtype),
    }


def _stack(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters drawn on ``device`` from ``seed``, with the JAX
    package's shapes, dtypes and std rules (not its draws)."""
    _require_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype_of(cfg.dtype)
    Vp, d = cfg.vocab_padded, cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (Vp, d), dtype),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
        "lm_head": dense_init(gen, (d, Vp), dtype),
    }
    # the stacked layer axis is drawn layer by layer, then stacked
    params["layers"] = _stack([_init_one_layer(cfg, gen, dtype) for _ in range(cfg.n_layers)])
    if cfg.arch_type == "hybrid":
        params["shared"] = {
            "ln1": torch.zeros((d,), dtype=dtype, device=device),
            "attn": attn_mod.init_attn_params(gen, cfg, dtype),
            "ln2": torch.zeros((d,), dtype=dtype, device=device),
            "mlp": mlp_mod.init_mlp_params(gen, _shared_mlp_cfg(cfg), dtype),
        }
    return params


def _layer_params_at(params, i: int) -> Dict[str, Any]:
    def at(node):
        return {k: at(v) for k, v in node.items()} if isinstance(node, dict) else node[i]

    return at(params["layers"])


def _is_local(cfg: ModelConfig, kind: str) -> bool:
    return cfg.local_ratio > 0 and kind == "local"


# ---------------------------------------------------------------------------
# layer application (forward / prefill)
# ---------------------------------------------------------------------------
def _dense_block(cfg: ModelConfig, lp, h: Tensor, positions: Tensor, is_local: bool):
    """(h after one attention + MLP block, its post-RoPE (k, v))."""
    att, kv = attn_mod.attention_train(
        rms_norm(h, lp["ln1"], cfg.norm_eps), lp["attn"], cfg, positions, is_local,
        return_kv=True,
    )
    h = h + att
    h = h + mlp_mod.mlp(rms_norm(h, lp["ln2"], cfg.norm_eps), lp["mlp"], cfg)
    return h, kv


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


def _scan_layers(cfg: ModelConfig, params, h: Tensor, positions: Tensor):
    """Run every layer over h. Returns (h, per-layer cache material): the
    (state, conv) of each Mamba2 layer, the (k, v) of each attention layer,
    and for the hybrid ``(ssm material, shared-block (k, v) per period)``."""
    if cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every
        ssm_out, shared_kv = [], []
        for pi in range(cfg.n_layers // every):
            for li in range(every):
                h, sc = _ssm_block(cfg, _layer_params_at(params, pi * every + li), h)
                ssm_out.append(sc)
            h, kv = _shared_block(cfg, params["shared"], h, positions)
            shared_kv.append(kv)
        return h, (ssm_out, shared_kv)
    collected = []
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = _layer_params_at(params, i)
        if cfg.arch_type == "ssm":
            h, c = _ssm_block(cfg, lp, h)
        else:
            h, c = _dense_block(cfg, lp, h, positions, _is_local(cfg, kind))
        collected.append(c)
    return h, collected


def _host_positions(S: int, true_len: Optional[int]) -> Tensor:
    """Prefill positions on the CPU (so ``attention_train`` checks them
    without a device sync): arange(S), or arange(true_len) then -1s."""
    pos = torch.arange(S)
    if true_len is not None:
        pos = torch.where(pos < true_len, pos, torch.full_like(pos, -1))
    return pos


def _forbid_grad_on_card(params, tokens: Tensor) -> None:
    """The kernels have no backward pass: refuse a graph-building forward
    on the card rather than give gradients that silently miss them."""
    if tokens.device.type != "cuda" or not torch.is_grad_enabled():
        return

    def leaves(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from leaves(v)
        else:
            yield node

    if any(t.requires_grad for t in leaves(params)):
        raise NotImplementedError(
            "forward_train on the card is forward only: the flash-attention and SSD "
            "kernels have no backward kernels yet (run under torch.no_grad())"
        )


def trunk(cfg: ModelConfig, params, tokens: Tensor) -> Tensor:
    """The final-normed hidden state (B, S, d) of every position."""
    _require_ported(cfg)
    _forbid_grad_on_card(params, tokens)
    h = params["embed"][tokens.long()]
    h, _ = _scan_layers(cfg, params, h, _host_positions(tokens.shape[1], None))
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def forward_train(cfg: ModelConfig, params, tokens: Tensor) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Logits (B, S, Vp) of every position and ``{"aux_loss": 0}`` (no
    MoE): the JAX package's ``forward_train`` as a forward-only oracle."""
    logits = trunk(cfg, params, tokens) @ params["lm_head"]
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecodeCache:
    # uniform archs: one dict of (n_layers, B, ...) stacked caches; others:
    # a list of per-layer (B, ...) caches (kv or ssm)
    layers: Union[Dict[str, Tensor], List[Dict[str, Tensor]]]
    position: Tensor  # scalar int32 (B=1 prefill) or (B,) — next position to write
    shared: Optional[List[Dict[str, Tensor]]] = None  # hybrid: shared-attn caches per period


def uniform_layers(cfg: ModelConfig) -> bool:
    """True when every layer has the same block kind and cache shape, so
    the cache stacks the layers as the JAX package's scanned decode does
    (dense archs without local layers, and the pure SSM)."""
    return (
        cfg.arch_type in ("dense", "moe", "ssm", "vlm")
        and cfg.local_ratio == 0
        and not cfg.is_encoder_decoder
    )


def _layer_cache_at(cache: DecodeCache, i: int) -> Dict[str, Tensor]:
    """Layer i's cache: views into the stacked tensors of a uniform arch
    (writes through them land in the stack)."""
    if isinstance(cache.layers, dict):
        return {k: v[i] for k, v in cache.layers.items()}
    return cache.layers[i]


def init_decode_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=None, device="cuda"
) -> DecodeCache:
    _require_ported(cfg)
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    kinds = cfg.layer_kinds()

    def one(kind):
        if kind == "ssm":
            return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        return attn_mod.init_kv_cache(cfg, batch, max_len, _is_local(cfg, kind), dtype, device)

    position = torch.zeros((), dtype=torch.int32, device=device)
    if uniform_layers(cfg):
        c = one(kinds[0])
        stacked = {k: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim) for k, v in c.items()}
        return DecodeCache(stacked, position)
    layers = [one(k) for k in kinds]
    shared = None
    if cfg.arch_type == "hybrid":
        shared = [one("global") for _ in range(cfg.n_layers // cfg.hybrid_attn_every)]
    return DecodeCache(layers, position, shared)


def decode_step(
    cfg: ModelConfig, params, token: Tensor, cache: DecodeCache
) -> Tuple[Tensor, DecodeCache]:
    """One-token decode. token: (B,) int. Returns (logits (B, Vp), cache).

    ``cache.position`` may be a scalar or a per-row ``(B,)`` vector. The
    layer caches are updated in place; the returned cache holds the same
    tensors and the advanced position."""
    _require_ported(cfg)
    pos = cache.position
    h = params["embed"][token.long()][:, None, :]  # (B, 1, d)
    period = cfg.hybrid_attn_every
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = _layer_params_at(params, i)
        lc = _layer_cache_at(cache, i)
        if kind == "ssm":
            out, _ = ssm_mod.ssm_block_decode(
                rms_norm(h, lp["ln1"], cfg.norm_eps), lc, lp["ssm"], cfg
            )
            h = h + out
        else:
            out, _ = attn_mod.attention_decode(
                rms_norm(h, lp["ln1"], cfg.norm_eps), lc, lp["attn"], cfg, pos,
                _is_local(cfg, kind),
            )
            h = h + out
            h = h + mlp_mod.mlp(rms_norm(h, lp["ln2"], cfg.norm_eps), lp["mlp"], cfg)
        if cfg.arch_type == "hybrid" and (i + 1) % period == 0:  # the shared block
            sp = params["shared"]
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
    true_len: Optional[int] = None,
) -> Tuple[Tensor, DecodeCache]:
    """Run the full prompt; return last-position logits (B, Vp) and a FILLED
    cache (k/v of every attention layer, ring placement for local layers;
    SSD final states and conv windows of every Mamba2 layer) with room for
    ``extra_len`` more tokens.

    ``true_len`` marks a RIGHT-padded prompt: only ``tokens[:, :true_len]``
    are real, the tail is bucket padding. Pad cache slots stay invalid
    (``pos = -1``), the logits are taken at ``true_len - 1`` and
    ``cache.position`` starts at ``true_len``. Only attention
    architectures take it: a state scan cannot skip pad steps, so the SSM
    and the hybrid prefill at exact length and raise on ``true_len``, as
    in the JAX package."""
    _require_ported(cfg)
    B, S = tokens.shape
    max_len = S + extra_len
    if true_len is not None:
        if cfg.arch_type in ("ssm", "hybrid"):
            raise ValueError(
                "true_len (pad-masked bucketed prefill) is only supported for "
                f"attention architectures, not arch_type={cfg.arch_type!r}; "
                "prefill those at exact length"
            )
        true_len = int(true_len)
        if not 1 <= true_len <= S:
            raise ValueError(f"true_len must be in [1, {S}], got {true_len}")
    positions = _host_positions(S, true_len)
    h = params["embed"][tokens.long()]
    h, collected = _scan_layers(cfg, params, h, positions)

    shared = None
    if cfg.arch_type == "hybrid":
        ssm_out, shared_kv = collected
        layers = [{"state": st, "conv": cv} for st, cv in ssm_out]
        shared = [attn_mod.cache_from_kv(cfg, k, v, False, max_len) for k, v in shared_kv]
    elif cfg.arch_type == "ssm":
        layers = [{"state": st, "conv": cv} for st, cv in collected]
    else:
        layers = [
            attn_mod.cache_from_kv(cfg, k, v, _is_local(cfg, kind), max_len, positions)
            for (k, v), kind in zip(collected, cfg.layer_kinds())
        ]
    if uniform_layers(cfg):
        layers = {k: torch.stack([c[k] for c in layers]) for k in layers[0]}
    del collected
    # only the last real position's logits are returned, so only they are formed
    last = S if true_len is None else true_len
    h = rms_norm(h[:, last - 1:last], params["final_norm"], cfg.norm_eps)
    logits = (h @ params["lm_head"])[:, 0]
    position = torch.tensor(last, dtype=torch.int32, device=h.device)
    return logits, DecodeCache(layers, position, shared)
