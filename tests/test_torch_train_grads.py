"""The port's ``loss_fn`` and its gradient against the JAX package's, on
the CPU.

For each family's reduced config (dense gemma3-1b at 6 layers so a global
layer appears, the VLM chameleon-34b, the MoE qwen3-moe-30b-a3b with its
router aux term, the encoder-decoder whisper-tiny, the pure SSM
mamba2-780m and the hybrid zamba2-2.7b), the JAX ``init_params`` carried
across with ``convert.lm_params_from_reference`` and one batch of 2 x 33
tokens: the loss, its parts and every gradient leaf against
``jax.value_and_grad(repro.models.loss_fn)``. Bar: 2e-5, the port's
forward bar (tests/test_torch_models_dense.py's blocks). Also: remat
recomputes each body and gives the same gradients, and the MoE's dispatch
and combine are the JAX package's custom-VJP gathers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import mlp as jmlp
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.tokens import embedding_side_inputs
from repro_torch.models import attention, loss_fn, mlp, transformer
from repro_torch.train.optimizer import tree_leaves, tree_map

TOL = 2e-5
# arch -> layers of the reduced config (None: reduced()'s own)
ARCHS = {"gemma3-1b": 6, "chameleon-34b": None, "qwen3-moe-30b-a3b": None,
         "whisper-tiny": None, "mamba2-780m": None, "zamba2-2.7b": None}
_MODELS = {}


def model(arch):
    """(cfg, jcfg, params, jparams), built once per arch and process."""
    if arch not in _MODELS:
        cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
        if ARCHS[arch]:
            cfg = dataclasses.replace(cfg, n_layers=ARCHS[arch])
            jcfg = dataclasses.replace(jcfg, n_layers=ARCHS[arch])
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                          device="cpu")
        _MODELS[arch] = (cfg, jcfg, params, jparams)
    return _MODELS[arch]


def batch_np(cfg, seed=0, B=2, S=33, masked=False):
    """tokens, labels (a few past the vocabulary: loss_fn clips them) and
    mask, plus an encoder-decoder's frames, as numpy arrays."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = cfg.vocab_padded + 7
    mask = np.ones((B, S), np.float32)
    if masked:
        mask[1, S // 2:] = 0.0
    out = {"tokens": toks, "labels": labels, "mask": mask}
    if cfg.is_encoder_decoder:
        out["frames"] = embedding_side_inputs("audio", B, cfg.d_model, seed=seed,
                                              frames=cfg.enc_frames)
    return out


def port_value_and_grad(cfg, params, batch):
    live = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    total, parts = loss_fn(cfg, live, {k: torch.from_numpy(v) for k, v in batch.items()})
    total.backward()
    return total.detach(), {k: v.detach() for k, v in parts.items()}, live


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_every_gradient_match_jax(arch):
    cfg, jcfg, params, jparams = model(arch)
    batch = batch_np(cfg, seed=1, masked=True)
    (jtotal, jparts), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    total, parts, live = port_value_and_grad(cfg, params, batch)
    np.testing.assert_allclose(float(total), float(jtotal), atol=TOL, rtol=0)
    for k in ("ce", "aux_loss"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), atol=TOL, rtol=0)
    if cfg.arch_type == "moe":
        assert float(parts["aux_loss"]) > 0  # the router's term is in the total
    jflat = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    flat = dict(_flat(live))
    assert sorted(flat) == sorted(jflat)
    for key, leaf in flat.items():
        assert leaf.grad is not None, key
        np.testing.assert_allclose(leaf.grad.numpy(), jflat[key], atol=TOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-tiny", "qwen3-moe-30b-a3b",
                                  "zamba2-2.7b", "mamba2-780m"])
def test_remat_recomputes_and_gives_the_same_gradients(arch, monkeypatch):
    """cfg.remat checkpoints each scanned body: its attention runs again in
    the backward pass, and the gradients are the ones without remat."""
    cfg, _, params, _ = model(arch)
    batch = batch_np(cfg, seed=2)
    calls = []
    inner = attention.attention_train

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(attention, "attention_train", counted)
    grads = {}
    for remat in (False, True):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        total, _, live = port_value_and_grad(c, params, batch)
        grads[remat] = (float(total), [t.grad for t in tree_leaves(live)], len(calls))
    assert grads[True][0] == grads[False][0]
    for a, b in zip(grads[True][1], grads[False][1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    n_attn = grads[False][2]
    if cfg.arch_type == "ssm":
        assert n_attn == 0
    else:
        assert n_attn > 0 and grads[True][2] == 2 * n_attn


def test_remat_is_off_without_a_graph():
    """Serving runs no graph: remat configs call each body once."""
    cfg, _, params, _ = model("gemma3-1b")
    c = dataclasses.replace(cfg, remat=True)
    toks = torch.from_numpy(batch_np(cfg)["tokens"])
    with torch.no_grad():
        a, _ = transformer.forward_train(c, params, toks)
        b, _ = transformer.forward_train(cfg, params, toks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_ffn_vjp_matches_jax_custom_vjp(cf):
    """One MoE layer's VJP (x and every expert and router leaf) against
    jax.vjp through the JAX package's custom-VJP gathers, with tokens
    dropped (cf 0.5: C = 8 slots for 12 assignments an expert) and at the
    reduced config's lossless capacity."""
    cfg, jcfg, params, jparams = model("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 24, cfg.d_model).astype(np.float32)
    g = rs.randn(2, 24, cfg.d_model).astype(np.float32)
    p = transformer._layer_params_at(params, 0)["moe"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    jy, vjp = jax.vjp(lambda xx, pp: jmlp.moe_ffn(xx, pp, jcfg)[0], jnp.asarray(x), jp)
    jgx, jgp = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    y, aux = mlp.moe_ffn(xt, pt, cfg)
    if cf == 0.5:
        assert float(aux["drop_frac"]) > 0
    y.backward(torch.from_numpy(g))
    # randn inputs at d = 256 give gradients up to about 34 (the router's),
    # so the bar is relative to the largest entry there
    for name, a, b in [("y", y.detach(), jy), ("x", xt.grad, jgx)] + [
            (k, pt[k].grad, jgp[k]) for k in pt]:
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / max(1.0, np.abs(b).max())
        assert err <= TOL, (name, err)


def test_moe_backward_goes_through_the_gathers():
    """The graph holds the two Functions, and each backward is the JAX
    package's gather: dispatch's gradient sums each token's k slots,
    combine's gathers each slot's (token, k) gradient."""
    cfg, jcfg, params, _ = model("qwen3-moe-30b-a3b")
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 16, cfg.d_model)
                         .astype(np.float32)).requires_grad_(True)
    y, _ = mlp.moe_ffn(x, transformer._layer_params_at(params, 0)["moe"], cfg)
    names, todo, seen = set(), [y.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    assert {"MoeDispatchBackward", "MoeCombineBackward"} <= names

    rs = np.random.RandomState(6)
    B, S, K, E, C, d = 2, 5, 2, 3, 4, 8
    e_flat = torch.from_numpy(rs.randint(0, E, (B, S * K)))
    oh = torch.nn.functional.one_hot(e_flat, E)
    pos = (torch.cumsum(oh, 1) - oh).gather(2, e_flat[..., None])[..., 0]
    pos_clip = torch.where(pos >= C, torch.full_like(pos, C), pos)
    slot_src = torch.full((B, E, C + 1), S, dtype=torch.long)
    slot_sk = torch.full((B, E, C + 1), S * K, dtype=torch.long)
    rows = torch.arange(B)[:, None]
    slot_src[rows, e_flat, pos_clip] = torch.arange(S * K).expand(B, -1) // K
    slot_sk[rows, e_flat, pos_clip] = torch.arange(S * K).expand(B, -1)
    slot_src, slot_sk = slot_src[..., :C], slot_sk[..., :C]
    xs = torch.from_numpy(rs.randn(B, S, d).astype(np.float32)).requires_grad_(True)
    gb = rs.randn(B, E, C, d).astype(np.float32)
    buf = mlp.MoeDispatch.apply(xs, slot_src, e_flat, pos_clip)
    buf.backward(torch.from_numpy(gb).transpose(0, 1))
    jbuf, jvjp = jax.vjp(lambda t: jmlp._moe_dispatch(t, jnp.asarray(slot_src.numpy()),
                                                      jnp.asarray(e_flat.numpy()),
                                                      jnp.asarray(pos_clip.numpy())),
                         jnp.asarray(xs.detach().numpy()))
    np.testing.assert_array_equal(buf.detach().transpose(0, 1).numpy(), np.asarray(jbuf))
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(jvjp(jnp.asarray(gb))[0]),
                               atol=1e-6, rtol=0)
    ob = torch.from_numpy(rs.randn(E, B, C, d).astype(np.float32)).requires_grad_(True)
    gy = rs.randn(B, S * K, d).astype(np.float32)
    y_flat = mlp.MoeCombine.apply(ob, e_flat, pos_clip, slot_sk)
    y_flat.backward(torch.from_numpy(gy))
    jy, jvjp = jax.vjp(lambda t: jmlp._moe_combine(t, jnp.asarray(e_flat.numpy()),
                                                   jnp.asarray(pos_clip.numpy()),
                                                   jnp.asarray(slot_sk.numpy())),
                       jnp.asarray(ob.detach().transpose(0, 1).numpy()))
    np.testing.assert_array_equal(y_flat.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ob.grad.transpose(0, 1).numpy(),
                                  np.asarray(jvjp(jnp.asarray(gy))[0]))


def test_loss_fn_without_mask_is_the_mean():
    cfg, _, params, _ = model("chameleon-34b")
    batch = batch_np(cfg, seed=3)
    del batch["mask"]
    with torch.no_grad():
        total, parts = loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
        logits, _ = transformer.forward_train(cfg, params, torch.from_numpy(batch["tokens"]))
    labels = torch.from_numpy(batch["labels"]).long().clamp(0, cfg.vocab_padded - 1)
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             labels.reshape(-1))
    torch.testing.assert_close(parts["ce"], want, atol=1e-6, rtol=1e-6)
    assert float(total) == float(parts["ce"]) and float(parts["aux_loss"]) == 0.0
