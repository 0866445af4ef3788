"""Language models of the JAX package's families: dense (local/global
attention + MLP blocks: qwen1.5, nemotron-4, gemma3, and the early-fusion
VLM chameleon, whose VQ image tokens arrive as ids), MoE (qwen3-moe,
kimi-k2: attention + Mixture-of-Experts blocks), pure SSM (Mamba2), the
zamba2-style hybrid (Mamba2 layers with one shared attention+MLP block
applied after every ``hybrid_attn_every`` of them) and the whisper-style
encoder-decoder (a non-causal encoder over precomputed audio frames, a
decoder with learned positions and cross-attention after every layer).

Entry points:
    init_params(cfg, seed, device)               -> param dict
    param_shapes(cfg)                            -> the same tree of meta tensors
    forward_train(cfg, params, tokens, side)     -> (logits, aux)
    loss_fn(cfg, params, batch)                  -> (loss, {"ce", "aux_loss"})
    encode_audio(cfg, params, frames)            -> encoder states (B, F, d)
    prefill(cfg, params, tokens, side)           -> (last_logits, DecodeCache)
    decode_step(cfg, params, token, cache)       -> (logits, DecodeCache)
    make_sharded_prefill(cfg, mesh, B, S)        -> (step, param, batch, cache shardings)
    make_sharded_decode_step(cfg, mesh, B, L)    -> (step, param, token, cache shardings)

Params are a plain dict with the JAX package's pytree keys, the layer axis
stacked in front (``params["layers"]["attn"]["wq"]`` is (n_layers, d,
H hd)), so a JAX pytree carries across leaf for leaf
(``convert.lm_params_from_reference``). The JAX package's ``lax.scan``
over layers is a Python loop here. Prefill goes through the two Hopper
kernels (flash attention in every attention layer, every application of
the shared block, every encoder layer and every cross-attention; the SSD
chunk in every Mamba2 layer); decode is plain torch, as in the JAX
package, and updates the cache in place.

Training differentiates ``forward_train`` with torch autograd. On the card
every attention runs K3 forward and K3-bwd backward
(``kernels.flash.ops.FlashAttention``), every Mamba2 layer's chunk-local
SSD runs K4 forward and K4-bwd backward (``kernels.ssd.ops.SSDChunk``),
and the MoE's dispatch and combine
are the JAX package's custom-VJP gathers (``mlp.MoeDispatch``,
``mlp.MoeCombine``). With ``cfg.remat`` each scanned body (a layer; a
hybrid's period; an encoder layer; a decoder layer with its
cross-attention) runs under ``torch.utils.checkpoint``, as the JAX package
wraps it in ``jax.checkpoint``: its activations are recomputed in the
backward pass, so K3 and K4 run twice per layer and step.

The sharded train step (``train.loop.make_sharded_train_step``) hands
the training entry points this rank's blocks of the params and a
``sharding.StepSharding`` (``shard=``): each body gathers its layer's
leaves over the batch axes (FSDP) as it starts, inside the remat
checkpoint, so autograd keeps the blocks and the recompute gathers again;
``embed`` and ``lm_head`` are gathered where they are read. The compute is
split over ``model`` as the specs split the leaves (``sharding.ModelSplit``):
attention by heads, the MLP by its hidden dim, the MoE by experts, Mamba2
by heads, the embedding by columns (the rows gathered along d) and the
loss by vocabulary (``_nll``), each block closing with one psum.

The sharded serving step (``make_sharded_prefill``,
``make_sharded_decode_step``: JAX's ``jit(prefill / decode_step,
in_shardings=...)`` of its dry run) hands ``prefill`` and ``decode_step``
a ``sharding.ServeSharding``: serve-mode params split over ``model`` only,
each rank its rows, and the decode cache in the layout of
``decode_cache_pspec`` (kv heads, or ``head_dim``, split over ``model``;
the slots over the batch axes when the batch is 1), over which each rank
attends alone.

Mixed dtypes follow JAX's type promotion, made explicit (torch does not
promote inside a matmul): fp32 audio frames plus a bf16 model run the
encoder in fp32 against the bf16 weights, so the cross-attention k/v and
their cache are fp32, while the decoder stream, its kv cache and the
logits stay bf16.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.dmtrl import resolve_device
from . import attention as attn_mod
from . import mlp as mlp_mod
from . import ssm as ssm_mod
from .common import dense_init, dtype_of, embed_init, rms_norm
from ..core import distributed as dist_mod
from .sharding import (
    MODEL_AXIS,
    NamedSharding,
    P,
    ServeSharding,
    decode_cache_shardings,
    entry_axes,
    model_split,
    param_shardings,
    spec_axes,
    train_batch_pspec,
    use,
)

Tensor = torch.Tensor

PORTED_ARCHS = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
DEC_POS_ROWS = 8192  # the encoder-decoder's learned decoder positions (they wrap)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in PORTED_ARCHS:
        raise NotImplementedError(
            f"arch_type={cfg.arch_type!r} ({cfg.name}) is not ported yet (the port "
            f"serves {', '.join(PORTED_ARCHS)})"
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
    p = {"ln1": zeros(), "attn": attn_mod.init_attn_params(gen, cfg, dtype), "ln2": zeros()}
    if cfg.arch_type == "moe":
        p["moe"] = mlp_mod.init_moe_params(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_mod.init_mlp_params(gen, cfg, dtype)
    return p


def _init_cross_layer(cfg: ModelConfig, gen: torch.Generator, dtype) -> Dict[str, Any]:
    return {
        "ln": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
        "attn": attn_mod.init_attn_params(gen, cfg, dtype),
    }


def _tree_map(fn, *trees):
    """``fn`` over the matching tensor leaves of nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _init_stacked(n: int, make) -> Dict[str, Any]:
    """``n`` layer trees from ``make()`` stacked on a leading axis. Each
    layer is drawn, copied into its slice of the preallocated stack and
    freed before the next is drawn, so the init holds the stack and one
    layer at most; a single layer is stacked as a view, with no copy."""
    layer = make()
    if n == 1:
        return _tree_map(lambda a: a.unsqueeze(0), layer)
    stack = _tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), layer)
    for i in range(n):
        if i:
            layer = make()
        _tree_map(lambda s, a: s[i].copy_(a), stack, layer)
        layer = None
    return stack


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random parameters drawn on ``device`` from ``seed``, with the JAX
    package's shapes, dtypes and std rules (not its draws)."""
    _require_ported(cfg)
    device = resolve_device(device)
    return _build_params(cfg, torch.Generator(device=device).manual_seed(seed), device)


class _ShapesOnly:
    """Stands in for the generator: every draw is an empty tensor on the
    meta device (``common.normal_init``)."""

    device = torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The param tree's shapes and dtypes without allocating: meta tensors
    (kimi-k2's 1T parameters included), the JAX package's ``param_shapes``."""
    _require_ported(cfg)
    return _build_params(cfg, _ShapesOnly(), torch.device("meta"))


def _build_params(cfg: ModelConfig, gen, device: torch.device) -> Dict[str, Any]:
    dtype = dtype_of(cfg.dtype)
    Vp, d = cfg.vocab_padded, cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=dtype, device=device)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (Vp, d), dtype),
        "final_norm": zeros(),
        "lm_head": dense_init(gen, (d, Vp), dtype),
    }
    params["layers"] = _init_stacked(cfg.n_layers, lambda: _init_one_layer(cfg, gen, dtype))
    if cfg.arch_type == "hybrid":
        params["shared"] = {
            "ln1": zeros(),
            "attn": attn_mod.init_attn_params(gen, cfg, dtype),
            "ln2": zeros(),
            "mlp": mlp_mod.init_mlp_params(gen, _shared_mlp_cfg(cfg), dtype),
        }
    if cfg.is_encoder_decoder:
        enc_cfg = dataclasses.replace(cfg, arch_type="dense")
        params["enc_layers"] = _init_stacked(
            cfg.n_enc_layers, lambda: _init_one_layer(enc_cfg, gen, dtype))
        params["enc_norm"] = zeros()
        params["enc_pos"] = embed_init(gen, (cfg.enc_frames, d), dtype)
        params["dec_pos"] = embed_init(gen, (DEC_POS_ROWS, d), dtype)
        params["cross_layers"] = _init_stacked(
            cfg.n_layers, lambda: _init_cross_layer(cfg, gen, dtype))
    return params


def _layer_params_at(params, i: int, key: str = "layers") -> Dict[str, Any]:
    return _tree_map(lambda a: a[i], params[key])


def _layers_of(params, n: int, key: str = "layers", shard=None) -> List[Dict[str, Any]]:
    """The ``n`` layers' params of the stacked tree ``params[key]``: views
    from one ``unbind`` of each leaf, whose backward stacks the layers'
    gradients at once (indexing layer by layer would add one full-size
    gradient per layer). Under the sharded step the leaves whose layer dim
    is split over the batch axes are gathered first
    (``StepSharding.gather_layers``)."""
    tree = params[key] if shard is None else shard.gather_layers(params[key], key)
    parts = _tree_map(lambda a: a.unbind(0), tree)
    return [_tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


def _maybe_remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat`` is
    set and autograd is recording: the JAX package's ``jax.checkpoint``
    (``nothing_saveable``) around a scanned body. Serving (no graph) calls
    ``fn`` directly."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _is_local(cfg: ModelConfig, kind: str) -> bool:
    return cfg.local_ratio > 0 and kind == "local"


def _promoted(tree, dtype: torch.dtype):
    """Every leaf of ``tree`` in its promoted dtype with ``dtype``: JAX
    computes an fp32 stream against bf16 weights in fp32, and torch's
    matmul wants one dtype."""
    return _tree_map(lambda a: a.to(torch.promote_types(a.dtype, dtype)), tree)


# ---------------------------------------------------------------------------
# layer application (forward / prefill)
# ---------------------------------------------------------------------------
def _ffn(cfg: ModelConfig, lp, x: Tensor, shard=None) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's feed-forward: (out, the MoE's aux_loss or None)."""
    if cfg.arch_type == "moe":
        y, aux = mlp_mod.moe_ffn(x, lp["moe"], cfg, shard=shard)
        return y, aux["aux_loss"]
    return mlp_mod.mlp(x, lp["mlp"], cfg, shard), None


def _dense_block(cfg: ModelConfig, lp, h: Tensor, positions: Tensor, is_local: bool,
                 aux_losses: Optional[List[Tensor]] = None, shard=None):
    """(h after one attention + MLP (or MoE) block, its post-RoPE (k, v));
    a MoE block appends its aux_loss to ``aux_losses``."""
    att, kv = attn_mod.attention_train(
        rms_norm(h, lp["ln1"], cfg.norm_eps), lp["attn"], cfg, positions, is_local,
        return_kv=True, shard=shard,
    )
    h = h + att
    y, aux_loss = _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps), shard)
    if aux_losses is not None and aux_loss is not None:
        aux_losses.append(aux_loss)
    return h + y, kv


def _dense_layer(cfg: ModelConfig, lp, h: Tensor, positions: Tensor, is_local: bool,
                 shard=None):
    """``_dense_block`` with the MoE's aux_loss returned (None for an MLP
    block), for a scanned body: remat runs a body twice, so it must not
    append to a list outside. The layer's leaves are gathered here, inside
    the body, when the sharded step passes ``shard``."""
    lp = use(shard, lp, "layers")
    aux: List[Tensor] = []
    h, kv = _dense_block(cfg, lp, h, positions, is_local, aux, shard)
    return h, kv, (aux[0] if aux else None)


def _ssm_block(cfg: ModelConfig, lp, h: Tensor, shard=None):
    """(h + Mamba2(h), (state, conv_window))."""
    lp = use(shard, lp, "layers")
    out, state, conv = ssm_mod.ssm_block_train(
        rms_norm(h, lp["ln1"], cfg.norm_eps), lp["ssm"], cfg, shard
    )
    return h + out, (state, conv)


def _shared_block(cfg: ModelConfig, sp, h: Tensor, positions: Tensor, shard=None):
    """(h after the shared attention + SwiGLU block, its post-RoPE (k, v))."""
    att, kv = attn_mod.attention_train(
        rms_norm(h, sp["ln1"], cfg.norm_eps), sp["attn"], cfg, positions, False,
        return_kv=True, shard=shard,
    )
    h = h + att
    h = h + mlp_mod.mlp(rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], _shared_mlp_cfg(cfg),
                        shard)
    return h, kv


def _scan_layers(cfg: ModelConfig, params, h: Tensor, positions: Tensor, shard=None):
    """Run every layer over h. Returns (h, per-layer cache material, the
    MoE aux_loss summed over layers): the (state, conv) of each Mamba2
    layer, the (k, v) of each attention layer, and for the hybrid
    ``(ssm material, shared-block (k, v) per period)``.

    With the sharded step's ``shard`` each body gathers its layers' leaves
    (and a hybrid period the shared block) from this rank's blocks as it
    starts: under remat autograd keeps the blocks, and the recompute
    gathers again."""
    aux_losses: List[Tensor] = []
    layers = _layers_of(params, cfg.n_layers, shard=shard)
    if cfg.arch_type == "hybrid":
        every = cfg.hybrid_attn_every

        def period(hh, lps):
            sc = []
            for lp in lps:
                hh, c = _ssm_block(cfg, lp, hh, shard)
                sc.append(c)
            sp = use(shard, params["shared"], "shared", stacked=False)
            hh, kv = _shared_block(cfg, sp, hh, positions, shard)
            return hh, sc, kv

        ssm_out, shared_kv = [], []
        for pi in range(cfg.n_layers // every):
            h, sc, kv = _maybe_remat(cfg, period, h, layers[pi * every:(pi + 1) * every])
            ssm_out.extend(sc)
            shared_kv.append(kv)
        collected: Any = (ssm_out, shared_kv)
    else:
        collected = []
        for lp, kind in zip(layers, cfg.layer_kinds()):
            if cfg.arch_type == "ssm":
                h, c = _maybe_remat(cfg, _ssm_block, cfg, lp, h, shard)
            else:
                h, c, aux_loss = _maybe_remat(cfg, _dense_layer, cfg, lp, h, positions,
                                              _is_local(cfg, kind), shard)
                if aux_loss is not None:
                    aux_losses.append(aux_loss)
            collected.append(c)
    aux = (torch.stack(aux_losses).sum() if aux_losses
           else torch.zeros((), dtype=torch.float32, device=h.device))
    return h, collected, aux


def encode_audio(cfg: ModelConfig, params, frames: Tensor, shard=None) -> Tensor:
    """Whisper-style encoder over precomputed frame embeddings (B, F, d):
    the learned frame positions, then non-causal attention + MLP layers
    (K3 on the card). The stream takes the dtype JAX promotes frames and
    weights to: fp32 frames against bf16 weights run in fp32."""
    F_ = frames.shape[1]
    h = frames + use(shard, params["enc_pos"], "enc_pos", stacked=False)[None, :F_]
    positions = _host_positions(F_, None)

    def layer(hh, lp):
        lp = _promoted(use(shard, lp, "enc_layers"), hh.dtype)
        hh = hh + attn_mod.attention_train(
            rms_norm(hh, lp["ln1"], cfg.norm_eps), lp["attn"], cfg, positions, False,
            causal=False, shard=shard,
        )
        return hh + mlp_mod.mlp(rms_norm(hh, lp["ln2"], cfg.norm_eps), lp["mlp"], cfg, shard)

    for lp in _layers_of(params, cfg.n_enc_layers, "enc_layers", shard):
        h = _maybe_remat(cfg, layer, h, lp)
    return rms_norm(h, use(shard, params["enc_norm"], "enc_norm", stacked=False), cfg.norm_eps)


def _embed(cfg: ModelConfig, params, tokens: Tensor, shard=None) -> Tensor:
    """The token embeddings (plus an encoder-decoder's decoder positions).
    Under the sharded step an ``embed`` split over ``model`` by columns
    looks up this rank's columns, and the rows are gathered along d."""
    embed = use(shard, params["embed"], "embed", stacked=False)
    h = embed[tokens.long()]
    if embed.shape[-1] != cfg.d_model:
        h = model_split(shard).gather_last(h)
    if cfg.is_encoder_decoder:  # learned decoder positions; past the table they wrap
        dec_pos = use(shard, params["dec_pos"], "dec_pos", stacked=False)
        rows = dec_pos.shape[0]
        h = h + dec_pos[torch.arange(tokens.shape[1], device=h.device) % rows][None]
    return h


def _cross_heads(cfg: ModelConfig, shard) -> Optional[int]:
    """The q heads a rank runs in cross-attention under the sharded step
    (all of them unless the spec splits ``wq`` over ``model``)."""
    if shard is None:
        return None
    spec = shard.shardings["cross_layers"]["attn"]["wq"].spec
    return cfg.n_heads // shard.split.size if MODEL_AXIS in spec_axes(spec) else cfg.n_heads


def _forward(cfg: ModelConfig, params, tokens: Tensor, side: Optional[Tensor],
             positions: Tensor, shard=None):
    """(h before the final norm, per-layer cache material, the MoE aux_loss,
    the cross-attention (k, v) of each decoder layer or None: under the
    serving step every head's, for the cache, of which this rank's heads
    attend)."""
    h = _embed(cfg, params, tokens, shard)
    if not cfg.is_encoder_decoder:
        return _scan_layers(cfg, params, h, positions, shard) + (None,)
    if side is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it needs its encoder frames (side=)")
    enc = encode_audio(cfg, params, side, shard)
    cross_layers = _layers_of(params, cfg.n_layers, "cross_layers", shard)
    # the cross k/v are made outside the decoder bodies, from each layer's
    # wk and wv (gathered here alone under the sharded step)
    cross_keys = ("wk", "wv")
    hl = _cross_heads(cfg, shard)
    weights = [use(shard, {"attn": {k: cp["attn"][k] for k in cross_keys}},
                   "cross_layers")["attn"] for cp in cross_layers]
    if shard is not None and shard.serving:
        # the cross cache holds every head: this rank's heads attend
        cross = [attn_mod.cross_cache_kv(enc, w, cfg, shard) for w in weights]
        q0 = shard.split.coord * hl
        heads = [(k, v) if hl == cfg.n_heads else
                 (k.narrow(2, q0, hl).contiguous(), v.narrow(2, q0, hl).contiguous())
                 for k, v in cross]
    else:
        cross = heads = [attn_mod.cross_kv(enc, w, cfg, shard, hl) for w in weights]
    del enc, weights

    def layer(hh, lp, cp, ck, cv):
        # wk and wv were read for the cross k/v: gather the rest alone
        cp = {"ln": cp["ln"], "attn": {k: w for k, w in cp["attn"].items()
                                       if k not in cross_keys}}
        lp, cp = use(shard, lp, "layers"), use(shard, cp, "cross_layers")
        hh, kv = _dense_block(cfg, lp, hh, positions, False, shard=shard)
        hh = hh + attn_mod.cross_attend(rms_norm(hh, cp["ln"], cfg.norm_eps), ck, cv,
                                        cp["attn"], cfg, shard)
        return hh, kv

    collected = []
    for lp, cp, (ck, cv) in zip(_layers_of(params, cfg.n_layers, shard=shard), cross_layers,
                                heads):
        h, kv = _maybe_remat(cfg, layer, h, lp, cp, ck, cv)
        collected.append(kv)
    return h, collected, torch.zeros((), dtype=torch.float32, device=h.device), cross


def _host_positions(S: int, true_len: Optional[int]) -> Tensor:
    """Prefill positions on the CPU (so ``attention_train`` checks them
    without a device sync): arange(S), or arange(true_len) then -1s."""
    pos = torch.arange(S)
    if true_len is not None:
        pos = torch.where(pos < true_len, pos, torch.full_like(pos, -1))
    return pos


def _trunk(cfg: ModelConfig, params, tokens: Tensor, side: Optional[Tensor], shard=None):
    _require_ported(cfg)
    h, _, aux, _ = _forward(cfg, params, tokens, side, _host_positions(tokens.shape[1], None),
                            shard)
    final_norm = use(shard, params["final_norm"], "final_norm", stacked=False)
    return rms_norm(h, final_norm, cfg.norm_eps), aux


def trunk(cfg: ModelConfig, params, tokens: Tensor, side: Optional[Tensor] = None) -> Tensor:
    """The final-normed hidden state (B, S, d) of every position."""
    return _trunk(cfg, params, tokens, side)[0]


def _lm_head_input(cfg: ModelConfig, lm_head: Tensor, h: Tensor, shard) -> Tensor:
    """h as it meets ``lm_head``: entering the split where the spec split
    the vocabulary (each rank then forms its columns of the logits)."""
    if lm_head.shape[-1] != cfg.vocab_padded:
        return model_split(shard).enter(h)
    return h


def forward_train(
    cfg: ModelConfig, params, tokens: Tensor, side: Optional[Tensor] = None, shard=None
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Logits (B, S, Vp) of every position and ``{"aux_loss": ...}`` (the
    MoE's load-balance loss summed over layers, 0 for the other archs): the
    JAX package's ``forward_train``, differentiable by autograd. ``side``
    carries an encoder-decoder's frames (B, F, d).

    ``shard`` (a ``sharding.StepSharding``, from
    ``train.loop.make_sharded_train_step``) says that ``params`` hold this
    rank's blocks: each leaf is gathered over the batch axes where it is
    used (a layer's inside its remat body), the compute is split over
    ``model`` as the specs split the leaves, and the MoE's aux loss is this
    rank's term of the batch's. The logits are then this rank's columns of
    the vocabulary when ``lm_head`` is split."""
    h, aux = _trunk(cfg, params, tokens, side, shard)
    lm_head = use(shard, params["lm_head"], "lm_head", stacked=False)
    return _lm_head_input(cfg, lm_head, h, shard) @ lm_head, {"aux_loss": aux}


def _nll(cfg: ModelConfig, logits: Tensor, labels: Tensor, shard=None) -> Tensor:
    """The next-token negative log-likelihood in fp32 of each position, from
    the logits (labels clipped into the padded vocabulary). Logits that are
    this rank's columns of a vocabulary split over ``model`` give the
    vocab-parallel cross entropy: the max over ``model``, the psum of the
    exp-sums and the gold logit from the rank whose columns hold the label,
    so the logsumexp still runs over every padded column and the full
    logits are never built."""
    logits = logits.float()
    labels = labels.long().clamp(0, cfg.vocab_padded - 1)
    vl = logits.shape[-1]
    if vl == cfg.vocab_padded:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return lse - gold
    tp = model_split(shard)
    m = tp.pmax(logits.detach().amax(dim=-1))
    lse = m + torch.log(tp.leave(torch.exp(logits - m[..., None]).sum(dim=-1)))
    local = labels - tp.coord * vl
    mine = (local >= 0) & (local < vl)
    gold = torch.gather(logits, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    gold = tp.leave(torch.where(mine, gold, torch.zeros_like(gold)))
    return lse - gold


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Tensor], shard=None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The JAX package's ``loss_fn``: the masked mean next-token cross
    entropy in fp32 (labels clipped into the padded vocabulary) plus
    ``router_aux_coef`` times the MoE's aux loss. ``batch`` holds
    ``tokens`` and ``labels`` (B, S), optionally ``mask`` (B, S) and an
    encoder-decoder's ``frames``. Returns ``(total, {"ce", "aux_loss"})``.

    Under the sharded step (``shard``) ``batch`` is this rank's rows, the
    mask's sum is taken over the batch axes, a vocabulary split over
    ``model`` takes the vocab-parallel cross entropy (``_nll``), and the
    returned terms are this rank's parts: summed over the batch axes they
    are the batch's."""
    logits, aux = forward_train(cfg, params, batch["tokens"], batch.get("frames"), shard)
    nll = _nll(cfg, logits, batch["labels"], shard)
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    count = torch.sum(mask)
    if shard is not None:
        count = shard.psum_batch(count)
    loss = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    total = loss + cfg.router_aux_coef * aux["aux_loss"]
    return total, {"ce": loss, "aux_loss": aux["aux_loss"]}


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
    cross: Optional[List[Tuple[Tensor, Tensor]]] = None  # enc-dec: (B, F, H, hd) k, v per layer


def uniform_layers(cfg: ModelConfig) -> bool:
    """True when every layer has the same block kind and cache shape, so
    the cache stacks the layers as the JAX package's scanned decode does
    (dense, MoE and VLM archs without local layers, and the pure SSM)."""
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
    cross = None
    if cfg.is_encoder_decoder:
        shape = (batch, cfg.enc_frames, cfg.n_heads, cfg.head_dim)
        cross = [(torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device)) for _ in range(cfg.n_layers)]
    return DecodeCache(layers, position, shared, cross)


def decode_step(
    cfg: ModelConfig, params, token: Tensor, cache: DecodeCache, shard=None
) -> Tuple[Tensor, DecodeCache]:
    """One-token decode. token: (B,) int. Returns (logits (B, Vp), cache).

    ``cache.position`` may be a scalar or a per-row ``(B,)`` vector. The
    layer caches are updated in place; the returned cache holds the same
    tensors and the advanced position.

    Under the sharded serving step (``shard``, a
    ``sharding.ServeSharding``; ``make_sharded_decode_step``) ``params``
    and ``cache`` are this rank's blocks under JAX's serve-mode and decode
    cache specs, ``token`` and a per-row position the whole batch's (they
    are replicated): the rank runs its rows, splits the compute over
    ``model`` as the specs split the leaves and attends over the cache
    block it holds (``attention.attention_decode``). The logits are this
    rank's rows and columns of the vocabulary (``sharding.logits_sharding``)."""
    _require_ported(cfg)
    pos = cache.position
    split = model_split(shard)
    rows_pos = pos
    if shard is not None:
        token = shard.rows(token)
        rows_pos = shard.rows(pos) if pos.ndim else pos
    embed = params["embed"]
    h = embed[token.long()][:, None, :]  # (B, 1, d)
    if embed.shape[-1] != cfg.d_model:  # this rank's columns
        h = split.gather(h, -1)
    if cfg.is_encoder_decoder:
        # a (1,) or (B,) index: a 0-d one would be read on the host
        idx = (rows_pos % params["dec_pos"].shape[0]).long().reshape(-1)
        h = h + params["dec_pos"][idx][:, None]  # (1 or B, 1, d)
    period = cfg.hybrid_attn_every
    for i, kind in enumerate(cfg.layer_kinds()):
        lp = _layer_params_at(params, i)
        lc = _layer_cache_at(cache, i)
        if kind == "ssm":
            out, _ = ssm_mod.ssm_block_decode(
                rms_norm(h, lp["ln1"], cfg.norm_eps), lc, lp["ssm"], cfg, shard
            )
            h = h + out
        else:
            out, _ = attn_mod.attention_decode(
                rms_norm(h, lp["ln1"], cfg.norm_eps), lc, lp["attn"], cfg, rows_pos,
                _is_local(cfg, kind), shard,
            )
            h = h + out
            h = h + _ffn(cfg, lp, rms_norm(h, lp["ln2"], cfg.norm_eps), shard)[0]
        if cfg.is_encoder_decoder:
            cp = _layer_params_at(params, i, "cross_layers")
            h = h + attn_mod.cross_attention_decode(
                rms_norm(h, cp["ln"], cfg.norm_eps), cache.cross[i], cp["attn"], cfg, shard
            )
        if cfg.arch_type == "hybrid" and (i + 1) % period == 0:  # the shared block
            sp = params["shared"]
            out, _ = attn_mod.attention_decode(
                rms_norm(h, sp["ln1"], cfg.norm_eps), cache.shared[(i + 1) // period - 1],
                sp["attn"], cfg, rows_pos, False, shard,
            )
            h = h + out
            h = h + mlp_mod.mlp(
                rms_norm(h, sp["ln2"], cfg.norm_eps), sp["mlp"], _shared_mlp_cfg(cfg), shard
            )
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    lm_head = params["lm_head"]
    logits = (_lm_head_input(cfg, lm_head, h, shard) @ lm_head)[:, 0]
    return logits, DecodeCache(cache.layers, pos + 1, cache.shared, cache.cross)


def prefill(
    cfg: ModelConfig,
    params,
    tokens: Tensor,  # (B, S) int
    side: Optional[Tensor] = None,  # enc-dec: encoder frames (B, F, d)
    extra_len: int = 1024,
    true_len: Optional[int] = None,
    shard=None,
) -> Tuple[Tensor, DecodeCache]:
    """Run the full prompt; return last-position logits (B, Vp) and a FILLED
    cache (k/v of every attention layer, ring placement for local layers;
    SSD final states and conv windows of every Mamba2 layer; an
    encoder-decoder's cross k/v of every layer from ``side``) with room
    for ``extra_len`` more tokens.

    ``true_len`` marks a RIGHT-padded prompt: only ``tokens[:, :true_len]``
    are real, the tail is bucket padding. Pad cache slots stay invalid
    (``pos = -1``), the logits are taken at ``true_len - 1`` and
    ``cache.position`` starts at ``true_len``. Only decoder-only attention
    architectures take it: a state scan cannot skip pad steps, so the SSM,
    the hybrid and the encoder-decoder prefill at exact length and raise
    on ``true_len``, as in the JAX package. A MoE routes the pad tokens
    too (after the real ones in the dispatch order, so they displace no
    real token), and its capacity follows the bucket's length.

    Under the sharded serving step (``shard``, a
    ``sharding.ServeSharding``; ``make_sharded_prefill``) ``params`` are
    this rank's blocks under JAX's serve-mode specs and ``tokens`` its
    rows (all of them where the batch axes split the sequence: the step
    gathers it first); the compute splits over ``model`` as in the train
    step (``_forward``), and the cache comes back as this rank's block of
    it under ``decode_cache_shardings`` (``attention.cache_from_kv``; the
    conv windows whole over ``model``), the logits as this rank's
    columns of the vocabulary."""
    _require_ported(cfg)
    B, S = tokens.shape
    max_len = S + extra_len
    if true_len is not None:
        if cfg.arch_type in ("ssm", "hybrid") or cfg.is_encoder_decoder:
            raise ValueError(
                "true_len (pad-masked bucketed prefill) is only supported for "
                f"attention architectures, not arch_type={cfg.arch_type!r} / "
                "encoder-decoder; prefill those at exact length"
            )
        true_len = int(true_len)
        if not 1 <= true_len <= S:
            raise ValueError(f"true_len must be in [1, {S}], got {true_len}")
    positions = _host_positions(S, true_len)
    h, collected, _, cross = _forward(cfg, params, tokens, side, positions, shard)
    split = model_split(shard)

    shared = None
    if cfg.arch_type == "hybrid":
        ssm_out, shared_kv = collected
        layers = [{"state": st, "conv": ssm_mod.full_conv_window(cv, cfg, split)}
                  for st, cv in ssm_out]
        shared = [attn_mod.cache_from_kv(cfg, k, v, False, max_len, shard=shard)
                  for k, v in shared_kv]
    elif cfg.arch_type == "ssm":
        layers = [{"state": st, "conv": ssm_mod.full_conv_window(cv, cfg, split)}
                  for st, cv in collected]
    else:
        layers = [
            attn_mod.cache_from_kv(cfg, k, v, _is_local(cfg, kind), max_len, positions, shard)
            for (k, v), kind in zip(collected, cfg.layer_kinds())
        ]
    if uniform_layers(cfg):
        layers = {k: torch.stack([c[k] for c in layers]) for k in layers[0]}
    del collected
    # only the last real position's logits are returned, so only they are formed
    last = S if true_len is None else true_len
    h = rms_norm(h[:, last - 1:last], use(shard, params["final_norm"], "final_norm", False),
                 cfg.norm_eps)
    lm_head = use(shard, params["lm_head"], "lm_head", stacked=False)
    logits = (_lm_head_input(cfg, lm_head, h, shard) @ lm_head)[:, 0]
    position = torch.tensor(last, dtype=torch.int32, device=h.device)
    return logits, DecodeCache(layers, position, shared, cross)


# ---------------------------------------------------------------------------
# the sharded serving step
# ---------------------------------------------------------------------------
def _serve_shardings(cfg: ModelConfig, mesh, global_batch: int, max_len: int):
    """(param shardings, cache shardings, the model's ``ServeSharding``) of
    the serving step for a global batch and a cache of ``max_len`` slots."""
    pshard = param_shardings(cfg, param_shapes(cfg), mesh, "serve")
    cache = init_decode_cache(cfg, global_batch, max_len, device="meta")
    cshard = decode_cache_shardings(cfg, mesh, global_batch, cache)
    return pshard, cshard, ServeSharding(mesh, pshard, cfg, global_batch)


def make_sharded_prefill(cfg: ModelConfig, mesh, global_batch: int, seq_len: int, *,
                         extra_len: int = 1024):
    """The prefill over a ``core.distributed.Mesh``, one process per
    position: the JAX dry run's ``jit(prefill, in_shardings=(serve-mode
    params, the batch by train_batch_pspec))``. Returns ``(step, pshard,
    batch_shard, cache_shard)``: the step and the ``NamedSharding`` trees
    of the params, the batch (``tokens``; an encoder-decoder's ``frames``
    by the batch's entry) and the cache it returns
    (``sharding.decode_cache_shardings`` for ``seq_len + extra_len``
    slots), whose ``shard`` gives a rank its blocks and ``gather`` (or
    ``sharding.gather_cache``) the whole.

    ``step(params, batch, true_len=None)`` takes this rank's blocks and
    returns ``(logits, cache)``: the logits this rank's block
    (``sharding.logits_sharding``), the cache its blocks, ready for
    ``make_sharded_decode_step``. A batch too small for the batch axes
    comes split along the sequence: the step gathers it, every rank runs
    the whole batch and keeps its block of the cache's slots. On one
    position it equals ``prefill`` bit for bit."""
    pshard, cshard, shard = _serve_shardings(cfg, mesh, global_batch, seq_len + extra_len)
    bspec = train_batch_pspec(mesh, global_batch)
    bshard = {"tokens": NamedSharding(mesh, bspec)}
    local = {"tokens": bshard["tokens"].shard_shape((global_batch, seq_len))}
    if cfg.is_encoder_decoder:
        bshard["frames"] = NamedSharding(mesh, P(bspec[0], None, None))
    seq_axes = entry_axes(bspec[1])

    def step(params, batch: Dict[str, Tensor], true_len: Optional[int] = None):
        for k in batch:
            if k not in bshard:
                raise ValueError(f"unknown batch entry {k!r}")
        if tuple(batch["tokens"].shape) != local["tokens"]:
            raise ValueError(f"batch['tokens'] has shape {tuple(batch['tokens'].shape)}; this "
                             f"rank's block of the ({global_batch}, {seq_len}) batch is "
                             f"{local['tokens']}")
        tokens = batch["tokens"]
        for a in reversed(seq_axes):  # the whole sequence on every rank
            tokens = dist_mod.all_gather_dim(tokens, mesh, a, 1)
        with torch.no_grad():
            return prefill(cfg, params, tokens, batch.get("frames"), extra_len, true_len,
                           shard=shard)

    return step, pshard, bshard, cshard


def make_sharded_decode_step(cfg: ModelConfig, mesh, global_batch: int, max_len: int):
    """One decode tick over a ``core.distributed.Mesh``: the JAX dry run's
    ``jit(decode_step, in_shardings=(serve-mode params, the token
    replicated, the cache shardings))``. Returns ``(step, pshard,
    token_shard, cache_shard)``, the cache's for ``max_len`` slots.

    ``step(params, token, cache)`` takes this rank's param and cache blocks
    and the whole (B,) token, updates the cache blocks in place and
    returns ``(logits, cache)``, the logits this rank's block
    (``sharding.logits_sharding``). Each rank attends over the cache block
    it holds; no collective moves a cache block
    (``attention.attention_decode``). On one position it equals
    ``decode_step`` bit for bit."""
    pshard, cshard, shard = _serve_shardings(cfg, mesh, global_batch, max_len)
    tshard = NamedSharding(mesh, P())

    def step(params, token: Tensor, cache: DecodeCache):
        if tuple(token.shape) != (global_batch,):
            raise ValueError(f"token has shape {tuple(token.shape)}, expected ({global_batch},)")
        with torch.no_grad():
            return decode_step(cfg, params, token, cache, shard=shard)

    return step, pshard, tshard, cshard
