"""The port's optimizer and training loop against the JAX package's, on the
CPU: ``AdamW.schedule`` and ``update`` on the same grads and state (atol
1e-6), five steps of ``train`` on reduced gemma3-1b from the same params
and batches (losses at rtol 1e-3), gradient accumulation over
microbatches (tests/test_train.py's bars: loss rel 1e-3, params atol
5e-3; against the JAX package's accumulated step, its metrics at rtol 1e-5
and the accumulated gradient, as the first moment, at atol 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.tokens import SyntheticTokenPipeline as JaxPipeline
from repro.data.tokens import TokenPipelineConfig as JaxPipelineConfig
from repro.models import init_params as jax_init_params
from repro.train import AdamW as JaxAdamW
from repro.train import train as jax_train
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import adamw_state_from_reference, lm_params_from_reference
from repro_torch.data.tokens import SyntheticTokenPipeline, TokenPipelineConfig
from repro_torch.train import AdamW, TrainLogger, loop, train
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def reduced_pair(arch, **changes):
    return (dataclasses.replace(get_config(arch).reduced(), **changes),
            dataclasses.replace(jax_get_config(arch).reduced(), **changes))


def jax_params(jcfg, seed=0):
    return jax_init_params(jcfg, jax.random.PRNGKey(seed))


def to_port(cfg, jparams):
    return lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_close(port_tree, jax_tree, atol):
    a = {k: v for k, v in _flat(tree_map(lambda t: t.detach().numpy(), port_tree))}
    b = dict(_flat(jax.tree.map(np.asarray, jax_tree)))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)


def test_schedule_matches_jax():
    opt = AdamW(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jopt = JaxAdamW(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(opt.schedule(0)) == pytest.approx(0.0)
    assert float(opt.schedule(10)) == pytest.approx(1e-3, rel=1e-3)
    assert float(opt.schedule(100)) == pytest.approx(1e-4, rel=1e-2)
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        assert float(opt.schedule(torch.tensor(s, dtype=torch.int32))) == pytest.approx(
            float(jopt.schedule(jnp.int32(s))), rel=1e-6, abs=1e-12)


def test_adamw_update_matches_jax():
    """Two updates on the same grads: the first from a fresh state, the
    second from JAX's state carried across (convert.adamw_state_from_reference);
    the gradient norm is above the clip, so clipping applies."""
    cfg, jcfg = reduced_pair("qwen1_5-4b")
    jp = jax_params(jcfg)
    opt, jopt = AdamW(**OPT), JaxAdamW(**OPT)
    rs = np.random.RandomState(0)
    grads_np = jax.tree.map(lambda a: (0.05 * rs.randn(*a.shape)).astype(np.float32), jp)
    jstate = jopt.init(jp)
    p = to_port(cfg, jp)
    state = opt.init(p)
    g = tree_map(torch.from_numpy, grads_np)
    jp1, jstate1, jm = jopt.update(jax.tree.map(jnp.asarray, grads_np), jstate, jp)
    p1, state1, m = opt.update(g, state, p)
    assert float(jm["grad_norm"]) > 1.0
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    assert p1 is p and int(state1.step) == int(jstate1.step) == 1
    assert_trees_close(p1, jp1, atol=1e-6)
    assert_trees_close(state1.mu, jstate1.mu, atol=1e-6)
    assert_trees_close(state1.nu, jstate1.nu, atol=1e-6)
    # the second step from JAX's state and params
    carried = adamw_state_from_reference(jax.tree.map(np.asarray, jstate1), device="cpu")
    p = to_port(cfg, jp1)
    jp2, jstate2, _ = jopt.update(jax.tree.map(jnp.asarray, grads_np), jstate1, jp1)
    p2, state2, _ = opt.update(g, carried, p)
    assert int(state2.step) == 2
    assert_trees_close(p2, jp2, atol=1e-6)
    assert_trees_close(state2.nu, jstate2.nu, atol=1e-6)


def test_tree_helpers_keep_jax_leaf_order():
    tree = {"b": torch.ones(1), "a": {"y": torch.zeros(2), "x": torch.full((3,), 2.0)}}
    leaves = tree_leaves(tree)
    assert [t.shape[0] for t in leaves] == [3, 2, 1]  # a/x, a/y, b: sorted keys
    back = tree_unflatten(tree, [t + 1 for t in leaves])
    assert list(back) == ["b", "a"] and torch.equal(back["a"]["x"], torch.full((3,), 3.0))


def test_train_matches_jax_train(monkeypatch):
    """Five steps on reduced gemma3-1b: the same params (JAX's init carried
    across in place of the port's draw) and the same batches (both
    pipelines from seed 0)."""
    cfg, jcfg = reduced_pair("gemma3-1b")
    jp = jax_params(jcfg, seed=0)
    monkeypatch.setattr(loop, "init_params", lambda c, seed, device: to_port(c, jp))
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=60)
    _, _, jhist = jax_train(jcfg, JaxAdamW(**kw),
                            iter(JaxPipeline(JaxPipelineConfig(jcfg.vocab_size, 64, 4, 0))),
                            steps=5, logger=_jax_logger())
    params, state, hist = train(cfg, AdamW(**kw),
                                iter(SyntheticTokenPipeline(
                                    TokenPipelineConfig(cfg.vocab_size, 64, 4, 0))),
                                steps=5, logger=TrainLogger(every=1), device="cpu")
    assert [h["step"] for h in hist] == list(range(5)) and int(state.step) == 5
    for h, jh in zip(hist, jhist):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert h[k] == pytest.approx(jh[k], rel=1e-3), (h["step"], k)
    assert hist[-1]["loss"] < hist[0]["loss"]


def _jax_logger():
    from repro.train import TrainLogger as JaxTrainLogger

    return JaxTrainLogger(every=1)


def test_microbatching_matches_full_batch_and_jax():
    cfg, jcfg = reduced_pair("qwen1_5-4b")
    jp = jax_params(jcfg)
    opt, jopt = AdamW(**OPT), JaxAdamW(**OPT)
    batch_np = next(iter(SyntheticTokenPipeline(TokenPipelineConfig(cfg.vocab_size, 32, 4, 0))))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    out = {}
    for mb in (1, 4):
        p = to_port(cfg, jp)
        out[mb] = make_train_step(cfg, opt, microbatches=mb)(p, opt.init(p), batch)
    (p1, _, m1), (p4, s4, m4) = out[1], out[4]
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-3)
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)
    jp4, js4, jm4 = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=4))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch_np.items()})
    for k in ("loss", "ce", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(m4[k]), float(jm4[k]), rtol=1e-5, atol=1e-7)
    # the accumulated gradient itself: the first moment is 0.1 x its clipped value
    assert_trees_close(s4.mu, js4.mu, atol=1e-6)
    # a first AdamW step moves each entry by lr x g / (|g| + eps), so an entry
    # whose gradient is near 0 may step differently, by at most 2 lr
    assert_trees_close(p4, jp4, atol=2 * OPT["lr"])


def test_microbatches_must_divide_the_batch():
    cfg, jcfg = reduced_pair("qwen1_5-4b")
    p = to_port(cfg, jax_params(jcfg))
    opt = AdamW(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(SyntheticTokenPipeline(
        TokenPipelineConfig(cfg.vocab_size, 8, 3, 0)))).items()}
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, opt, microbatches=2)(p, opt.init(p), batch)


def test_train_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg, _ = reduced_pair("gemma3-1b")
    data = iter(SyntheticTokenPipeline(TokenPipelineConfig(cfg.vocab_size, 8, 2, 0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, AdamW(), data, steps=1)
