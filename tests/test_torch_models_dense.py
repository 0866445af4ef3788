"""Port's dense and pure-SSM LMs against the JAX package's, on the CPU.

qwen1.5-4b (MHA, QKV bias, SwiGLU), gemma3-1b (GQA, q/k norms, GELU,
local sliding-window layers with a global one every sixth: reduced to 6
layers so that a global layer appears), nemotron-4-15b (squared ReLU),
chameleon-34b (the early-fusion VLM: arch_type "vlm" runs the dense path,
GQA with q/k norms) and mamba2-780m (pure SSM), each ``get_config(...).reduced()``, with the JAX
``init_params`` carried across by ``convert.lm_params_from_reference``.
Bars (tests/test_serve.py): ``prefill`` last logits 2e-4, three
``decode_step``s 5e-4, decode far past gemma3's window and past three SSD
chunks 1e-3; the blocks and the cache 2e-5.
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
from repro_torch.models import (
    attention,
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
    transformer,
)

# arch -> layers of the reduced config (None: reduced()'s own 2)
ARCHS = {"qwen1_5-4b": None, "gemma3-1b": 6, "nemotron-4-15b": None, "chameleon-34b": None,
         "mamba2-780m": None}
DENSE = ("qwen1_5-4b", "gemma3-1b", "nemotron-4-15b", "chameleon-34b")


def reduced_pair(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if ARCHS.get(arch):
        cfg = dataclasses.replace(cfg, n_layers=ARCHS[arch])
        jcfg = dataclasses.replace(jcfg, n_layers=ARCHS[arch])
    return cfg, jcfg


_MODELS = {}


def model(arch):
    """(cfg, jcfg, params, jparams), built once per arch and process."""
    if arch not in _MODELS:
        cfg, jcfg = reduced_pair(arch)
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                          device="cpu")
        _MODELS[arch] = (cfg, jcfg, params, jparams)
    return _MODELS[arch]


def _tokens(seed, cfg, shape):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=shape).astype(np.int32)


def _layer_caches(cache):
    """Per-layer cache dicts of a DecodeCache of either package (stacked
    uniform caches are split along the layer axis)."""
    if isinstance(cache.layers, dict):
        n = next(iter(cache.layers.values())).shape[0]
        return [{k: v[i] for k, v in cache.layers.items()} for i in range(n)]
    return list(cache.layers)


def _assert_caches_match(cache, jcache, atol=2e-5):
    """Every layer's SSM state and conv window, or its k/v at every slot
    JAX marks valid (pos >= 0) and the pos array itself."""
    mine, ref = _layer_caches(cache), _layer_caches(jcache)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert set(a) == set(b)
        if "state" in b:
            for k in ("state", "conv"):
                np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=atol)
            continue
        pos = np.asarray(b["pos"])
        np.testing.assert_array_equal(np.asarray(a["pos"]), pos)
        valid = pos >= 0
        for k in ("k", "v"):
            assert tuple(a[k].shape) == tuple(b[k].shape)
            np.testing.assert_allclose(np.asarray(a[k])[valid], np.asarray(b[k])[valid],
                                       atol=atol)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_copy_matches_reference(arch):
    mine, ref = reduced_pair(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.layer_kinds() == ref.layer_kinds()
    assert transformer.uniform_layers(mine) == jtransformer.uniform_layers(ref)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_has_the_reference_tree(arch):
    """The port's own init (torch.Generator) gives the JAX pytree's keys,
    shapes and dtypes (bq/bk/bv, q_norm/k_norm, the MLP of each act), and
    is reproducible from its seed."""
    cfg, _, converted, _ = model(arch)
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
    assert torch.all(mine["layers"]["ln1"] == 0)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_block_matches_jax(arch):
    """One attention + MLP block, local and global, with its k/v."""
    cfg, jcfg, params, jparams = model(arch)
    x = np.random.RandomState(3).randn(2, 40, cfg.d_model).astype(np.float32)
    lp = transformer._layer_params_at(params, 0)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    for local in ((False, True) if cfg.window else (False,)):
        got, (k, v) = transformer._dense_block(cfg, lp, torch.from_numpy(x), torch.arange(40),
                                               local)
        want, _, (jk, jv) = jtransformer._dense_block(jcfg, jlp, jnp.asarray(x), jnp.arange(40),
                                                      local, collect=True)
        for a, b in ((got, want), (k, jk), (v, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("S", [24, 3])
def test_prefill_and_decode_match_jax(arch, S):
    cfg, jcfg, params, jparams = model(arch)
    toks = _tokens(S, cfg, (2, S + 3))
    last, cache = prefill(cfg, params, torch.from_numpy(toks[:, :S]), extra_len=8)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks[:, :S]), extra_len=8)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    assert int(cache.position) == S
    _assert_caches_match(cache, jcache)
    for t in range(3):
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, S + t]), cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(toks[:, S + t]), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)
    assert int(cache.position) == S + 3
    _assert_caches_match(cache, jcache, atol=5e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_bucketed_prefill_matches_jax(arch):
    """A right-padded bucket of 32 with true_len 21: the logits at position
    20, the cache (every entry JAX marks valid, pads at pos -1, the next
    position 21), and the decode steps that follow."""
    cfg, jcfg, params, jparams = model(arch)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :21] = _tokens(21, cfg, (21,))
    last, cache = prefill(cfg, params, torch.from_numpy(toks), extra_len=8, true_len=21)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks), extra_len=8,
                                true_len=jnp.asarray(21, jnp.int32))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    assert int(cache.position) == int(jcache.position) == 21
    _assert_caches_match(cache, jcache)
    exact, _ = prefill(cfg, params, torch.from_numpy(toks[:, :21]), extra_len=19)
    torch.testing.assert_close(last, exact, atol=2e-5, rtol=0)
    for t, tok in enumerate((5, 7, 11)):
        tt = np.asarray([tok], np.int32)
        out, cache = decode_step(cfg, params, torch.from_numpy(tt), cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(tt), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_train_matches_jax(arch):
    cfg, jcfg, params, jparams = model(arch)
    toks = _tokens(11, cfg, (2, 37))
    logits, aux = forward_train(cfg, params, torch.from_numpy(toks))
    jlogits, jaux = jax_forward_train(jcfg, jparams, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4)
    assert float(aux["aux_loss"]) == float(jaux["aux_loss"]) == 0.0


def test_sliding_window_ring_buffer_long_decode():
    """gemma3's local layers: decoding far past the window agrees with the
    JAX forward (ring overwrite; tests/test_serve.py's bar, 1e-3)."""
    cfg, jcfg, params, jparams = model("gemma3-1b")
    assert cfg.window and "global" in cfg.layer_kinds() and "local" in cfg.layer_kinds()
    S_total, S0 = cfg.window * 3 + 7, 4
    toks = _tokens(3, cfg, (1, S_total))
    ref, _ = jax_forward_train(jcfg, jparams, jnp.asarray(toks))
    ref = np.asarray(ref)
    _, cache = prefill(cfg, params, torch.from_numpy(toks[:, :S0]), extra_len=S_total)
    local = [c for c, k in zip(cache.layers, cfg.layer_kinds()) if k == "local"]
    assert tuple(local[0]["k"].shape[:2]) == (1, cfg.window)
    for t in range(S0, S_total):
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, t]), cache)
        if t % 17 == 0 or t == S_total - 1:
            np.testing.assert_allclose(out.numpy(), ref[:, t], atol=1e-3, err_msg=f"t={t}")


def test_ring_buffer_prefill_past_the_window_matches_jax():
    """A prompt longer than the window (and a bucket past it): the local
    layers keep the last ``window`` real entries in their ring slots."""
    cfg, jcfg, params, jparams = model("gemma3-1b")
    L, S = cfg.window + 9, 64
    toks = np.zeros((1, S), np.int32)
    toks[0, :L] = _tokens(4, cfg, (L,))
    last, cache = prefill(cfg, params, torch.from_numpy(toks), extra_len=8, true_len=L)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks), extra_len=8,
                                true_len=jnp.asarray(L, jnp.int32))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    _assert_caches_match(cache, jcache)
    for tok in (3, 9):
        tt = np.asarray([tok], np.int32)
        out, cache = decode_step(cfg, params, torch.from_numpy(tt), cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(tt), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)


def test_ssm_state_decode_long():
    """mamba2: O(1)-state decode tracks the JAX chunked forward over more
    than two chunks (tests/test_serve.py's bar, 1e-3)."""
    cfg, jcfg, params, jparams = model("mamba2-780m")
    S_total, S0 = cfg.ssm_chunk * 3 + 5, 8
    toks = _tokens(4, cfg, (2, S_total))
    ref, _ = jax_forward_train(jcfg, jparams, jnp.asarray(toks))
    _, cache = prefill(cfg, params, torch.from_numpy(toks[:, :S0]))
    for t in range(S0, S_total):
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, t]), cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, -1], atol=1e-3)


def test_ssm_prefill_refuses_true_len():
    cfg, _, params, _ = model("mamba2-780m")
    with pytest.raises(ValueError, match="exact length"):
        prefill(cfg, params, torch.zeros((1, 8), dtype=torch.int64), true_len=5)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-tiny", "chameleon-34b"])
def test_unported_archs_raise(arch):
    """Every config of configs/ is ported now; an arch_type the port does
    not know still raises from every entry point."""
    assert get_config(arch).arch_type in transformer.PORTED_ARCHS
    cfg = dataclasses.replace(get_config(arch).reduced(), arch_type="retnet")
    for call in (lambda: init_params(cfg, device="cpu"),
                 lambda: init_decode_cache(cfg, 1, 16, device="cpu"),
                 lambda: lm_params_from_reference(cfg, {}, device="cpu")):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            call()


@pytest.mark.parametrize("arch,uniform", [("qwen1_5-4b", True), ("mamba2-780m", True),
                                          ("gemma3-1b", False)])
def test_decode_cache_layout(arch, uniform):
    """Uniform archs stack the layer caches (n_layers, B, ...) as the JAX
    package's scanned decode does; gemma3 keeps a list, its local layers a
    ring of min(window, max_len) slots."""
    cfg, jcfg, _, _ = model(arch)
    cache = init_decode_cache(cfg, 3, 50, device="cpu")
    jcache = jtransformer.init_decode_cache(jcfg, 3, 50)
    assert isinstance(cache.layers, dict) is uniform is isinstance(jcache.layers, dict)
    for a, b in zip(_layer_caches(cache), _layer_caches(jcache)):
        for k in b:
            assert tuple(a[k].shape) == tuple(b[k].shape) and str(a[k].dtype) == f"torch.{b[k].dtype}"
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("L,S,window,max_len", [(37, 40, 16, 48), (10, 16, 16, 26),
                                                (40, 40, 16, 44), (12, 12, 16, 14), (5, 5, 0, 9)])
def test_cache_from_kv_matches_jax(L, S, window, max_len):
    """Ring placement and pad slots, against the JAX cache_from_kv."""
    cfg, jcfg = (dataclasses.replace(c, window=window) for c in reduced_pair("gemma3-1b"))
    rs = np.random.RandomState(L + S)
    k, v = (rs.randn(2, S, cfg.n_kv_heads, cfg.head_dim).astype(np.float32) for _ in range(2))
    pos = np.where(np.arange(S) < L, np.arange(S), -1).astype(np.int32)
    for local in (True, False):
        got = attention.cache_from_kv(cfg, torch.from_numpy(k), torch.from_numpy(v), local,
                                      max_len, torch.from_numpy(pos))
        want = jattention.cache_from_kv(jcfg, jnp.asarray(k), jnp.asarray(v), local, max_len,
                                        positions=jnp.asarray(pos))
        wpos = np.asarray(want["pos"])
        np.testing.assert_array_equal(got["pos"].numpy(), wpos)
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name].numpy()[wpos >= 0],
                                          np.asarray(want[name])[wpos >= 0])


def test_attention_decode_local_matches_jax():
    """Per-row positions on both sides of the window: the ring slot is
    pos % size and keys older than the window are masked."""
    cfg, jcfg, params, jparams = model("gemma3-1b")
    lp = transformer._layer_params_at(params, 0)["attn"]
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    rs = np.random.RandomState(8)
    B, W = 3, cfg.window
    cache = attention.init_kv_cache(cfg, B, 100, True, torch.float32, "cpu")
    jcache = jattention.init_kv_cache(jcfg, B, 100, True, jnp.float32)
    start = np.array([0, W - 3, 2 * W + 5])
    for t in range(6):
        x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
        pos = start + t
        out, cache = attention.attention_decode(torch.from_numpy(x), cache, lp, cfg,
                                                torch.from_numpy(pos), True)
        jout, jcache = jattention.attention_decode(jnp.asarray(x), jcache, jlp, jcfg,
                                                   jnp.asarray(pos, jnp.int32), True)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("positions", [[-1, 0, 1, 2], [0, 1, 3, -1], [0, 1, -1, 3], [1, 2, 3, 4]])
def test_attention_refuses_other_position_patterns(positions):
    """Only arange(L) followed by -1s (a right-padded bucket) is masked
    correctly by the kernel's index-causal mask; anything else raises."""
    cfg, _, params, _ = model("qwen1_5-4b")
    x = torch.zeros((1, 4, cfg.d_model))
    lp = transformer._layer_params_at(params, 0)["attn"]
    with pytest.raises(ValueError, match="right-padded"):
        attention.attention_train(x, lp, cfg, torch.tensor(positions), False)
    assert attention.real_length(torch.tensor([0, 1, 2, -1])) == 3
