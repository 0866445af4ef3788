"""Port's encoder-decoder LM (whisper-tiny) against the JAX package's, on
the CPU.

``get_config("whisper-tiny").reduced()`` (2 encoder and 2 decoder layers,
64 frames, fp32), with the JAX ``init_params`` carried across by
``convert.lm_params_from_reference`` and the frames from
``data.tokens.embedding_side_inputs("audio", ...)``. Bars
(tests/test_serve.py): blocks 2e-5, ``prefill`` last logits 2e-4,
``decode_step`` 5e-4. A bf16 copy of the config holds the port to JAX's
type promotion: fp32 frames make the encoder's output and the cross k/v
fp32, the self-attention cache and the logits stay bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattention
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.tokens import embedding_side_inputs
from repro_torch.models import (
    attention,
    decode_step,
    encode_audio,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
    transformer,
)

ARCH = "whisper-tiny"
_MODELS = {}


def model(dtype="float32"):
    """(cfg, jcfg, params, jparams), built once per dtype and process."""
    if dtype not in _MODELS:
        cfg, jcfg = (dataclasses.replace(c.reduced(), dtype=dtype)
                     for c in (get_config(ARCH), jax_get_config(ARCH)))
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                          device="cpu")
        _MODELS[dtype] = (cfg, jcfg, params, jparams)
    return _MODELS[dtype]


def _frames(cfg, batch, seed=0):
    return embedding_side_inputs("audio", batch, cfg.d_model, seed=seed, frames=cfg.enc_frames)


def _tokens(seed, cfg, shape):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=shape).astype(np.int32)


def test_config_copy_matches_reference():
    mine, ref = model()[:2]
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.is_encoder_decoder and mine.n_enc_layers == 2 and mine.enc_frames == 64
    assert transformer.uniform_layers(mine) == jtransformer.uniform_layers(ref) is False


def test_init_params_has_the_reference_tree():
    """enc_layers, enc_norm, enc_pos, dec_pos (8192 rows) and cross_layers
    with the JAX pytree's keys, shapes and dtypes; reproducible."""
    cfg, _, converted, _ = model()
    mine = init_params(cfg, seed=0, device="cpu")
    again = init_params(cfg, seed=0, device="cpu")

    def walk(a, b, c, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], c[k], f"{path}/{k}")
            return
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(a, c), path

    walk(mine, converted, again)
    assert tuple(mine["dec_pos"].shape) == (transformer.DEC_POS_ROWS, cfg.d_model)
    assert tuple(mine["enc_pos"].shape) == (cfg.enc_frames, cfg.d_model)
    assert mine["enc_layers"]["attn"]["wq"].shape[0] == cfg.n_enc_layers


def test_encode_audio_matches_jax():
    cfg, jcfg, params, jparams = model()
    frames = _frames(cfg, 2, seed=1)
    got = encode_audio(cfg, params, torch.from_numpy(frames))
    want = jtransformer.encode_audio(jcfg, jparams, jnp.asarray(frames))
    assert tuple(got.shape) == (2, cfg.enc_frames, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_cross_attention_train_and_decode_match_jax():
    """Queries of 29 decoder positions against the 64 frames, and one
    token against the cached expanded k/v; the cache is what JAX's
    prefill stores."""
    cfg, jcfg, params, jparams = model()
    rs = np.random.RandomState(5)
    x = rs.randn(2, 29, cfg.d_model).astype(np.float32)
    enc = rs.randn(2, cfg.enc_frames, cfg.d_model).astype(np.float32)
    p = transformer._layer_params_at(params, 1, "cross_layers")["attn"]
    jp = jax.tree.map(lambda a: a[1], jparams["cross_layers"])["attn"]
    got = attention.cross_attention_train(torch.from_numpy(x), torch.from_numpy(enc), p, cfg)
    want = jattention.cross_attention_train(jnp.asarray(x), jnp.asarray(enc), jp, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    k, v = attention.cross_kv(torch.from_numpy(enc), p, cfg)
    assert tuple(k.shape) == (2, cfg.enc_frames, cfg.n_heads, cfg.head_dim)
    x1 = x[:, :1]
    got = attention.cross_attention_decode(torch.from_numpy(x1), (k, v), p, cfg)
    want = jattention.cross_attention_decode(jnp.asarray(x1), (jnp.asarray(k.numpy()),
                                                               jnp.asarray(v.numpy())), jp, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [24, 3])
def test_prefill_and_decode_with_side_match_jax(S):
    cfg, jcfg, params, jparams = model()
    toks = _tokens(S, cfg, (2, S + 3))
    frames = _frames(cfg, 2, seed=S)
    last, cache = prefill(cfg, params, torch.from_numpy(toks[:, :S]), torch.from_numpy(frames),
                          extra_len=8)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks[:, :S]), jnp.asarray(frames),
                                extra_len=8)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    assert int(cache.position) == S and len(cache.cross) == cfg.n_layers
    for (k, v), (jk, jv) in zip(cache.cross, jcache.cross):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=2e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-5)
    for a, b in zip(cache.layers, jcache.layers):
        np.testing.assert_array_equal(a["pos"].numpy(), np.asarray(b["pos"]))
        valid = np.asarray(b["pos"]) >= 0
        np.testing.assert_allclose(a["k"].numpy()[valid], np.asarray(b["k"])[valid], atol=2e-5)
    for t in range(3):
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, S + t]), cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(toks[:, S + t]), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)
    assert int(cache.position) == S + 3


def test_decode_with_per_row_positions_matches_jax():
    """The engine's batch cache: each row at its own position (dec_pos
    per row), against JAX's decode on the same cache."""
    cfg, jcfg, params, jparams = model()
    toks = _tokens(7, cfg, (2, 12))
    frames = _frames(cfg, 2, seed=7)
    _, cache = prefill(cfg, params, torch.from_numpy(toks), torch.from_numpy(frames),
                       extra_len=8)
    _, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks), jnp.asarray(frames), extra_len=8)
    pos = np.array([12, 9], np.int32)
    cache.position = torch.from_numpy(pos)
    jcache = jtransformer.DecodeCache(jcache.layers, jnp.asarray(pos), None, jcache.cross)
    tok = np.array([3, 4], np.int32)
    out, _ = decode_step(cfg, params, torch.from_numpy(tok), cache)
    jout, _ = jax_decode_step(jcfg, jparams, jnp.asarray(tok), jcache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)


def test_forward_train_with_side_matches_jax():
    cfg, jcfg, params, jparams = model()
    toks = _tokens(11, cfg, (2, 37))
    frames = _frames(cfg, 2, seed=11)
    logits, aux = forward_train(cfg, params, torch.from_numpy(toks), torch.from_numpy(frames))
    jlogits, jaux = jax_forward_train(jcfg, jparams, jnp.asarray(toks), jnp.asarray(frames))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4)
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0


def test_bf16_dtypes_follow_jax_promotion():
    """bf16 weights with fp32 frames: encode_audio's output and the cross
    k/v are fp32 (frames + enc_pos promotes; the encoder runs in fp32, so
    they agree with JAX's to fp32 rounding), every other cache leaf and
    the logits are bf16, as in the JAX package."""
    cfg, jcfg, params, jparams = model("bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    frames = _frames(cfg, 1, seed=2)
    toks = _tokens(2, cfg, (1, 20))
    enc = encode_audio(cfg, params, torch.from_numpy(frames))
    jenc = jtransformer.encode_audio(jcfg, jparams, jnp.asarray(frames))
    assert str(enc.dtype) == f"torch.{jenc.dtype}" == "torch.float32"
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=2e-5, rtol=1e-5)
    last, cache = prefill(cfg, params, torch.from_numpy(toks), torch.from_numpy(frames),
                          extra_len=8)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks), jnp.asarray(frames),
                                extra_len=8)

    def dtype_of(t):
        return str(t.dtype).replace("torch.", "")

    assert dtype_of(last) == str(jlast.dtype) == "bfloat16"
    assert dtype_of(cache.position) == str(jcache.position.dtype)
    for a, b in zip(cache.layers, jcache.layers):
        assert {k: dtype_of(v) for k, v in a.items()} == {k: str(v.dtype) for k, v in b.items()}
    for (k, v), (jk, jv) in zip(cache.cross, jcache.cross):
        assert dtype_of(k) == dtype_of(v) == str(jk.dtype) == str(jv.dtype) == "float32"
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=2e-5)
    out, cache = decode_step(cfg, params, torch.tensor([3]), cache)
    jout, _ = jax_decode_step(jcfg, jparams, jnp.asarray([3], jnp.int32), jcache)
    assert dtype_of(out) == str(jout.dtype) == "bfloat16"
    assert bool(torch.isfinite(out.float()).all())


def test_init_decode_cache_has_the_cross_slots():
    cfg, jcfg, _, _ = model()
    cache = init_decode_cache(cfg, 3, 40, device="cpu")
    jcache = jtransformer.init_decode_cache(jcfg, 3, 40)
    assert isinstance(cache.layers, list) and len(cache.cross) == cfg.n_layers
    for (k, v), (jk, jv) in zip(cache.cross, jcache.cross):
        assert tuple(k.shape) == tuple(jk.shape) == (3, cfg.enc_frames, cfg.n_heads, cfg.head_dim)
        assert tuple(v.shape) == tuple(jv.shape)
    for a, b in zip(cache.layers, jcache.layers):
        for name in b:
            assert tuple(a[name].shape) == tuple(b[name].shape)


def test_prefill_needs_frames_and_exact_length():
    cfg, _, params, _ = model()
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="encoder frames"):
        prefill(cfg, params, toks)
    with pytest.raises(ValueError, match="exact length"):
        prefill(cfg, params, toks, torch.from_numpy(_frames(cfg, 1)), true_len=5)
