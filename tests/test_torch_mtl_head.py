"""Port's backbone <-> DMTRL head bridge (train/mtl_head) against the JAX
package's, on the CPU.

The backbone is gemma3-1b reduced to 6 layers (local and global attention
layers) and mamba2-780m reduced, with the JAX ``init_params`` carried
across. Tasks follow the band recipe of examples/train_lm_mtl.py (each task
prefers a token band; the label says whether a sequence leans into it).
Bars: the pooled features 1e-5; a fit on identical features W 2e-4 and
Sigma 1e-5 (tests/test_distributed.py's fit bars).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import DMTRLConfig as JaxDMTRLConfig
from repro.models import init_params as jax_init_params
from repro.train import mtl_head as jax_mtl_head
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import DMTRLConfig, from_task_list
from repro_torch.train import (
    MTLHeadResult,
    build_mtl_data_from_backbone,
    fit_mtl_heads,
    mtl_head,
    pooled_features,
)

FIT = dict(loss="hinge", lam=1e-3, outer_iters=3, rounds=4, local_iters=64, seed=0)


def band_tasks(vocab, m_tasks=4, n_per_task=24, seq=16, seed=0):
    """examples/train_lm_mtl.py's make_task_datasets, at a small size."""
    rng = np.random.RandomState(seed)
    tokens, labels = [], []
    for t in range(m_tasks):
        lo, hi = (t * vocab) // m_tasks, ((t + 1) * vocab) // m_tasks
        toks = np.zeros((n_per_task, seq), np.int32)
        y = np.zeros((n_per_task,), np.float32)
        for i in range(n_per_task):
            pos = rng.rand() < 0.5
            toks[i] = rng.randint(lo, hi, size=seq) if pos else rng.randint(0, vocab, size=seq)
            y[i] = 1.0 if pos else -1.0
        tokens.append(toks)
        labels.append(y)
    return tokens, labels


_MODELS = {}


def backbone(arch):
    if arch not in _MODELS:
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        if arch == "gemma3-1b":
            cfg, jcfg = (dataclasses.replace(c, n_layers=6) for c in (cfg, jcfg))
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
        params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
        _MODELS[arch] = (cfg, jcfg, params, jparams)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
def test_pooled_features_match_jax(arch):
    cfg, jcfg, params, jparams = backbone(arch)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(3, 40)).astype(np.int32)
    got = pooled_features(cfg, params, torch.from_numpy(toks))
    want = jax_mtl_head.pooled_features(jcfg, jparams, jnp.asarray(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mtl_data_from_backbone_matches_jax():
    cfg, jcfg, params, jparams = backbone("gemma3-1b")
    toks, labs = band_tasks(cfg.vocab_size)
    data = build_mtl_data_from_backbone(cfg, params, toks, labs, batch=10, device="cpu")
    jdata = jax_mtl_head.build_mtl_data_from_backbone(jcfg, jparams, toks, labs, batch=10)
    np.testing.assert_allclose(data.x.numpy(), np.asarray(jdata.x), atol=1e-5)
    for name in ("y", "mask", "n"):
        np.testing.assert_array_equal(getattr(data, name).numpy(),
                                      np.asarray(getattr(jdata, name)))
    norms = np.linalg.norm(data.x.numpy(), axis=-1)
    np.testing.assert_allclose(norms[data.mask.numpy() > 0], 1.0, atol=1e-5)


def test_fit_mtl_heads_on_identical_features_matches_jax(monkeypatch):
    """The JAX bridge's features handed to the port's fit: W and Sigma
    within the fit bars, the same predictions."""
    cfg, jcfg, params, jparams = backbone("gemma3-1b")
    toks, labs = band_tasks(cfg.vocab_size)
    jdata = jax_mtl_head.build_mtl_data_from_backbone(jcfg, jparams, toks, labs)
    xs = [np.asarray(jdata.x[t, : int(jdata.n[t])]) for t in range(len(toks))]
    monkeypatch.setattr(mtl_head, "build_mtl_data_from_backbone",
                        lambda *a, **k: from_task_list(xs, labs, device="cpu"))
    res = fit_mtl_heads(cfg, params, toks, labs, DMTRLConfig(**FIT), device="cpu")
    jres = jax_mtl_head.fit_mtl_heads(jcfg, jparams, toks, labs, JaxDMTRLConfig(**FIT))
    assert isinstance(res, MTLHeadResult) and res.features_dim == jres.features_dim == cfg.d_model
    np.testing.assert_allclose(res.dmtrl.W.numpy(), np.asarray(jres.dmtrl.W), atol=2e-4)
    np.testing.assert_allclose(res.dmtrl.sigma.numpy(), np.asarray(jres.dmtrl.sigma), atol=1e-5)
    np.testing.assert_allclose(res.predict(xs[1], 1), jres.predict(xs[1], 1), atol=2e-4)


def test_fit_mtl_heads_end_to_end_shrinks_the_gap():
    """The port's own features and fit: the gap shrinks, and the heads
    separate the band tasks on held-out data better than chance."""
    from repro_torch.core import dual

    cfg, _, params, _ = backbone("gemma3-1b")
    toks, labs = band_tasks(cfg.vocab_size, n_per_task=48)
    res = fit_mtl_heads(cfg, params, toks, labs, DMTRLConfig(**FIT), device="cpu")
    gap = res.dmtrl.history["gap"]
    assert np.all(np.isfinite(gap)) and gap[-1] < gap[0]
    toks_te, labs_te = band_tasks(cfg.vocab_size, n_per_task=48, seed=1)
    te = build_mtl_data_from_backbone(cfg, params, toks_te, labs_te, device="cpu")
    assert float(dual.error_rate(te, res.dmtrl.W)) < 0.5


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg, _, params, _ = backbone("gemma3-1b")
    toks, labs = band_tasks(cfg.vocab_size, m_tasks=2, n_per_task=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mtl_data_from_backbone(cfg, params, toks, labs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_mtl_heads(cfg, params, toks, labs)
