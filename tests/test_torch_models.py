"""Port's hybrid LM (zamba2 family) against the JAX package's, on the CPU.

``get_config("zamba2-2_7b").reduced()`` (4 Mamba2 layers, d_model 128, the
shared attention block after every 2) with the JAX ``init_params`` carried
across by ``convert.lm_params_from_reference``. Bars: the blocks 2e-5;
``prefill`` last logits 2e-4 and three ``decode_step``s 5e-4 (the bars of
tests/test_serve.py::test_prefill_decode_matches_forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcommon
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import (
    common,
    decode_step,
    forward_train,
    init_params,
    prefill,
    ssm,
    transformer,
)

ARCH = "zamba2-2_7b"


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH).reduced()
    jcfg = jax_get_config(ARCH).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, params, jparams


def _hidden(seed, cfg, B=2, S=24):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(np.float32)


def test_config_copy_matches_reference():
    for arch in ("zamba2-2.7b", "mamba2-780m", "gemma3-1b", "qwen1_5-4b"):
        mine, ref = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
        assert mine.param_count() == ref.param_count()


def test_primitives_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 3, 16).astype(np.float32)
    scale = (0.1 * rs.randn(16)).astype(np.float32)
    gate = rs.randn(2, 5, 3, 16).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    tx = torch.from_numpy(x)
    pairs = [
        (common.rms_norm(tx, torch.from_numpy(scale)), jcommon.rms_norm(x, scale)),
        (common.gated_rms_norm(tx, torch.from_numpy(gate), torch.from_numpy(scale)),
         jcommon.gated_rms_norm(x, gate, scale)),
        (common.apply_rope(tx, torch.from_numpy(pos), 1e4), jcommon.apply_rope(x, pos, 1e4)),
    ]
    pairs += [(common.activation(a)(tx), jcommon.activation(a)(x))
              for a in ("gelu", "silu", "squared_relu")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-6)


def test_init_params_has_the_reference_tree(model):
    """The port's own init (torch.Generator) gives the JAX pytree's keys,
    shapes and dtypes, and is reproducible from its seed."""
    cfg, _, converted, _ = model
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
    # the init rules: unit-rms projections, zero norms, A in [-16, -1]
    assert torch.all(mine["layers"]["ln1"] == 0)
    A = -torch.exp(mine["layers"]["ssm"]["A_log"])
    assert torch.allclose(A[0], torch.linspace(-1.0, -16.0, cfg.ssm_heads))


def test_entry_points_default_to_the_card(model):
    cfg = model[0]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)


def test_unported_archs_raise():
    """Every config of configs/ is ported; an unknown arch_type raises."""
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.models.transformer import PORTED_ARCHS

    assert all(get_config(a).arch_type in PORTED_ARCHS for a in ARCH_IDS)
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), arch_type="retnet")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        init_params(cfg, device="cpu")


def test_ssm_block_train_matches_jax(model):
    cfg, jcfg, params, jparams = model
    x = _hidden(1, cfg)
    lp = transformer._layer_params_at(params, 1)["ssm"]
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"])["ssm"]
    got = ssm.ssm_block_train(torch.from_numpy(x), lp, cfg)
    want = jssm.ssm_block_train(jnp.asarray(x), jlp, jcfg)
    for a, b in zip(got, want):  # out, final state, conv window
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5)


def test_shared_block_matches_jax(model):
    cfg, jcfg, params, jparams = model
    x = _hidden(2, cfg)
    S = x.shape[1]
    got, (k, v) = transformer._shared_block(cfg, params["shared"], torch.from_numpy(x),
                                            torch.arange(S))
    want, (jk, jv) = jtransformer._shared_block(jcfg, jparams["shared"], jnp.asarray(x),
                                                jnp.arange(S), collect=True)
    for a, b in ((got, want), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [24, 3])
def test_prefill_and_decode_match_jax(model, S):
    cfg, jcfg, params, jparams = model
    toks = np.random.RandomState(S).randint(0, cfg.vocab_size, size=(2, S + 3)).astype(np.int32)
    last, cache = prefill(cfg, params, torch.from_numpy(toks[:, :S]), extra_len=8)
    jlast, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks[:, :S]), extra_len=8)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    assert int(cache.position) == S and len(cache.shared) == 2
    for a, b in zip(cache.layers, jcache.layers):
        np.testing.assert_allclose(a["state"].numpy(), np.asarray(b["state"]), atol=2e-5)
        np.testing.assert_allclose(a["conv"].numpy(), np.asarray(b["conv"]), atol=2e-5)
    for t in range(3):
        out, cache = decode_step(cfg, params, torch.from_numpy(toks[:, S + t]), cache)
        jout, jcache = jax_decode_step(jcfg, jparams, jnp.asarray(toks[:, S + t]), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4)
    assert int(cache.position) == S + 3


def test_prefill_plus_decode_tracks_longer_prefill(model):
    """The serving invariant (tests/test_serve.py) inside the port: prefill
    of S tokens and one decode step give the last logits of a prefill over
    S + 1 tokens (per-row positions, as the engine's batch cache has)."""
    cfg, _, params, _ = model
    toks = torch.from_numpy(np.random.RandomState(9).randint(0, cfg.vocab_size, (1, 21)))
    _, cache = prefill(cfg, params, toks[:, :20], extra_len=4)
    cache.position = cache.position.reshape(1)
    out, _ = decode_step(cfg, params, toks[:, 20], cache)
    want, _ = prefill(cfg, params, toks, extra_len=4)
    torch.testing.assert_close(out, want, atol=5e-4, rtol=0)


def test_bucketed_prefill_is_refused(model):
    cfg, _, params, _ = model
    with pytest.raises(ValueError, match="exact length"):
        prefill(cfg, params, torch.zeros((1, 8), dtype=torch.int64), true_len=torch.tensor(5))


def test_forward_train_matches_jax(model):
    """The hybrid's all-position logits (the forward-only oracle)."""
    cfg, jcfg, params, jparams = model
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, size=(2, 21)).astype(np.int32)
    logits, _ = forward_train(cfg, params, torch.from_numpy(toks))
    want, _ = jax_forward_train(jcfg, jparams, jnp.asarray(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4)


def test_nemotron_config_copy_matches_reference():
    mine, ref = get_config("nemotron-4-15b"), jax_get_config("nemotron-4-15b")
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    assert mine.param_count() == ref.param_count()
