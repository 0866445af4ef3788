"""Port's MoE LMs (qwen3-moe-30b-a3b, kimi-k2-1t-a32b) against the JAX
package's, on the CPU.

Each arch is ``get_config(...).reduced()`` (4 experts, top-2, kimi-k2 with
its shared expert; the reduced rule's lossless capacity factor E / K),
with the JAX ``init_params`` carried across by
``convert.lm_params_from_reference``. Bars (tests/test_serve.py): blocks
and ``moe_ffn`` 2e-5, ``prefill`` last logits 2e-4, ``decode_step`` 5e-4.
The routing must be JAX's exactly: the same experts (``jax.lax.top_k``,
ties to the lower index) and the same dropped tokens at a capacity that
drops, at the configs' own capacity factor too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import mlp as jmlp
from repro.models import prefill as jax_prefill
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import (
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    mlp,
    prefill,
    transformer,
)

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
_MODELS = {}


def model(arch, **changes):
    """(cfg, jcfg, params, jparams) of the reduced arch (with ``changes``
    to both configs), built once per arch and process."""
    key = (arch, tuple(sorted(changes.items())))
    if key not in _MODELS:
        cfg, jcfg = (dataclasses.replace(c.reduced(), **changes)
                     for c in (get_config(arch), jax_get_config(arch)))
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                          device="cpu")
        _MODELS[key] = (cfg, jcfg, params, jparams)
    return _MODELS[key]


def _tokens(seed, cfg, shape):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=shape).astype(np.int32)


def _jax_expert_idx(jcfg, p, x):
    """JAX's routing of x: the top-k experts of the fp32 router softmax."""
    probs = jax.nn.softmax(jnp.asarray(x).astype(jnp.float32) @ p["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    mine, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    assert transformer.uniform_layers(mine) == jtransformer.uniform_layers(ref) is True


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """The port's own init gives the JAX pytree's keys, shapes and dtypes
    (the fp32 router, the stacked experts, kimi-k2's shared expert), and
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
    moe = mine["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert ("shared_gate" in moe) == bool(cfg.n_shared_experts)
    # fan-in d for the experts' gate, f for their down projection
    torch.testing.assert_close(moe["w_gate"].std().item(), cfg.d_model ** -0.5, rtol=0.05, atol=0)
    torch.testing.assert_close(moe["w_down"].std().item(), cfg.d_ff ** -0.5, rtol=0.05, atol=0)


@pytest.mark.parametrize("cf", [1.25, 1.0, 2.0])
@pytest.mark.parametrize("S", [1, 17, 64, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, S, cf):
    cfg = dataclasses.replace(get_config(arch), capacity_factor=cf)
    jcfg = dataclasses.replace(jax_get_config(arch), capacity_factor=cf)
    assert mlp._capacity(S, cfg) == jmlp._capacity(S, jcfg)


def test_capacity_of_the_full_configs():
    """C at a 512-token prefill and at a decode step, at the configs' own
    factor of 1.25."""
    assert mlp._capacity(512, get_config("qwen3-moe-30b-a3b")) == 40
    assert mlp._capacity(512, get_config("kimi-k2-1t-a32b")) == 16
    assert mlp._capacity(1, get_config("qwen3-moe-30b-a3b")) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch):
    """Output, aux metrics and the routing of one MoE layer."""
    cfg, jcfg, params, jparams = model(arch)
    x = np.random.RandomState(3).randn(2, 40, cfg.d_model).astype(np.float32)
    p = transformer._layer_params_at(params, 0)["moe"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    y, aux = mlp.moe_ffn(torch.from_numpy(x), p, cfg)
    jy, jaux = jmlp.moe_ffn(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5, rtol=1e-5)
    for k in ("aux_loss", "router_entropy"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"]) == 0.0  # lossless capacity
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), _jax_expert_idx(jcfg, jp, x))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_the_tokens_jax_drops(arch):
    """capacity_factor 1.0 over 96 tokens a row (C = 48 of 192
    assignments): tokens are dropped, the same fraction as JAX's, and the
    output (which a different drop set would change) agrees."""
    cfg, jcfg, params, jparams = model(arch, capacity_factor=1.0)
    x = np.random.RandomState(4).randn(3, 96, cfg.d_model).astype(np.float32)
    p = transformer._layer_params_at(params, 1)["moe"]
    jp = jax.tree.map(lambda a: a[1], jparams["layers"])["moe"]
    y, aux = mlp.moe_ffn(torch.from_numpy(x), p, cfg)
    jy, jaux = jmlp.moe_ffn(jnp.asarray(x), jp, jcfg)
    assert float(jaux["drop_frac"]) > 0.0
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])
    np.testing.assert_array_equal(aux["expert_idx"].numpy(), _jax_expert_idx(jcfg, jp, x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5, rtol=1e-5)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1], [0.25, 0.25, 0.25, 0.25, 0.0, 0.0]],
                     np.float32)
    vals, idx = mlp._top_k(torch.from_numpy(probs), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [24, 3])
def test_prefill_and_decode_match_jax(arch, S):
    cfg, jcfg, params, jparams = model(arch)
    toks = _tokens(S, cfg, (2, S + 3))
    last, cache = prefill(cfg, params, torch.from_numpy(toks[:, :S]), extra_len=8)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks[:, :S]), extra_len=8)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    assert isinstance(cache.layers, dict) and isinstance(jcache.layers, dict)
    for k in ("k", "v", "pos"):
        assert tuple(cache.layers[k].shape) == tuple(jcache.layers[k].shape)
    np.testing.assert_array_equal(cache.layers["pos"].numpy(), np.asarray(jcache.layers["pos"]))
    for t in range(3):
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, S + t]), cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(toks[:, S + t]), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)
    assert int(cache.position) == S + 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 1.25])
def test_bucketed_prefill_matches_jax(arch, cf):
    """A right-padded bucket of 32 with true_len 21 against JAX's bucketed
    prefill, at the reduced rule's lossless capacity (where it also equals
    an exact-length prefill) and at the configs' own factor of 1.25 (where
    the capacity follows the bucket, as in JAX)."""
    changes = {} if cf is None else {"capacity_factor": cf}
    cfg, jcfg, params, jparams = model(arch, **changes)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :21] = _tokens(21, cfg, (21,))
    last, cache = prefill(cfg, params, torch.from_numpy(toks), extra_len=8, true_len=21)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks), extra_len=8,
                                true_len=jnp.asarray(21, jnp.int32))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    assert int(cache.position) == int(jcache.position) == 21
    np.testing.assert_array_equal(cache.layers["pos"].numpy(), np.asarray(jcache.layers["pos"]))
    if cf is None:
        exact, _ = prefill(cfg, params, torch.from_numpy(toks[:, :21]), extra_len=19)
        torch.testing.assert_close(last, exact, atol=2e-5, rtol=0)
    for tok in (5, 7):
        tt = np.asarray([tok], np.int32)
        out, cache = decode_step(cfg, params, torch.from_numpy(tt), cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(tt), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch):
    """Logits, and the aux loss summed over the MoE layers."""
    cfg, jcfg, params, jparams = model(arch)
    toks = _tokens(11, cfg, (2, 37))
    logits, aux = forward_train(cfg, params, torch.from_numpy(toks))
    jlogits, jaux = jax_forward_train(jcfg, jparams, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=2e-4)
    assert float(jaux["aux_loss"]) > 0.0
    np.testing.assert_allclose(float(aux["aux_loss"]), float(jaux["aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_is_stacked(arch):
    """MoE is a uniform arch: the cache stacks the layers (n_layers, B, ...)."""
    cfg, jcfg, _, _ = model(arch)
    cache = init_decode_cache(cfg, 3, 50, device="cpu")
    jcache = jtransformer.init_decode_cache(jcfg, 3, 50)
    assert isinstance(cache.layers, dict) and cache.cross is None
    for k, v in jcache.layers.items():
        assert tuple(cache.layers[k].shape) == tuple(v.shape)
        np.testing.assert_array_equal(cache.layers[k].numpy(), np.asarray(v))
