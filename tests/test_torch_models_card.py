"""The port's model paths on the card against the same model on the CPU
(marker ``gpu``: they skip without a card). This module imports
no JAX, so that the card's run, which has no JAX, can collect it:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_models_card.py

A small gemma3-shaped model keeps gemma3-1b's head dim of 256 (4 heads, 1
KV head, local layers with a global one after every second) at a narrow
width, in fp32: the card's prefill runs the fp32 flash kernel, the CPU's
its plain version, so the logits agree to float summation order (bar
2e-4, the prefill bar of tests/test_serve.py). The reduced MoE and the
reduced whisper (its encoder and cross-attention through the kernel's
non-causal mode) are held the same way, with decode steps at 5e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.tokens import embedding_side_inputs
from repro_torch.kernels.flash import flash_kernel
from repro_torch.kernels.ssd import ssd_kernel
from repro_torch.models import decode_step, forward_train, init_params, prefill
from repro_torch.train import pooled_features


def gemma_like():
    return dataclasses.replace(
        get_config("gemma3-1b").reduced(), n_layers=3, d_head=256, local_ratio=2, window=64,
    )


def test_gemma_like_config_is_what_the_card_tests_assume():
    cfg = gemma_like()
    assert cfg.head_dim == 256 and cfg.n_heads == 4 and cfg.n_kv_heads == 1
    assert cfg.layer_kinds() == ("local", "local", "global")
    assert cfg.dtype == "float32"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(params, device):
    if isinstance(params, dict):
        return {k: _on(v, device) for k, v in params.items()}
    return params.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("true_len", [None, 150])
def test_head_dim_256_prefill_and_decode_on_card(cuda, true_len):
    cfg = gemma_like()
    params = init_params(cfg, seed=0, device="cpu")
    gparams = _on(params, cuda)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 200)))
    before = flash_kernel.flash_attention.launches
    last, cache = prefill(cfg, gparams, toks.to(cuda), extra_len=8, true_len=true_len)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + cfg.n_layers
    want, wcache = prefill(cfg, params, toks, extra_len=8, true_len=true_len)
    torch.testing.assert_close(last.cpu(), want, atol=2e-4, rtol=0)
    for t in (3, 17, 29):
        tok = torch.tensor([t])
        out, cache = decode_step(cfg, gparams, tok.to(cuda), cache)
        wout, wcache = decode_step(cfg, params, tok, wcache)
        torch.testing.assert_close(out.cpu(), wout, atol=5e-4, rtol=0)


@pytest.mark.gpu
def test_mamba2_layout_prefill_on_card(cuda):
    """The pure SSM at mamba2-780m's head layout (P = 64, N = 128 cut to
    the reduced config's 32 here) through the SSD chunk kernel."""
    cfg = get_config("mamba2-780m").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    gparams = _on(params, cuda)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 70)))
    before = ssd_kernel.ssd_chunk_kernel.launches
    last, _ = prefill(cfg, gparams, toks.to(cuda), extra_len=4)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_kernel.launches == before + cfg.n_layers
    want, _ = prefill(cfg, params, toks, extra_len=4)
    torch.testing.assert_close(last.cpu(), want, atol=2e-4, rtol=0)


@pytest.mark.gpu
def test_forward_is_forward_only_on_card(cuda):
    """The gemma-shaped model trains on the card (K3 forward with lse, then
    K3-bwd, once per layer), its gradient against the CPU's autograd of the
    plain attention (bar 2e-4, the prefill bar); a Mamba2 model's graph on
    the card is refused, since the SSD chunk kernel (K4) has no backward
    kernel. Under no_grad both run, and pooled_features always does."""
    from repro_torch.models import loss_fn

    cfg = gemma_like()
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, cfg.vocab_size, (1, 72)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    grads = {}
    for dev in ("cpu", cuda):
        live = {k: v for k, v in _on(params, dev).items()}
        live["embed"] = live["embed"].detach().requires_grad_(True)
        live["layers"]["attn"]["wq"] = live["layers"]["attn"]["wq"].detach().requires_grad_(True)
        before = (flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches)
        loss, _ = loss_fn(cfg, live, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        after = (flash_kernel.flash_attention.launches, flash_kernel.flash_attention_bwd.launches)
        grads[str(dev)] = (loss.item(), live["embed"].grad.cpu(),
                           live["layers"]["attn"]["wq"].grad.cpu(), before, after)
    cpu, card = grads["cpu"], grads[str(cuda)]
    assert cpu[3] == cpu[4]
    assert card[4] == (card[3][0] + cfg.n_layers, card[3][1] + cfg.n_layers)
    assert abs(cpu[0] - card[0]) <= 2e-4
    for a, b in zip(cpu[1:3], card[1:3]):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=0)

    mcfg = get_config("mamba2-780m").reduced()
    mparams = init_params(mcfg, seed=0, device=cuda)
    mparams["embed"].requires_grad_(True)
    mtoks = torch.zeros((1, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(NotImplementedError, match="K4"):
        forward_train(mcfg, mparams, mtoks)
    with torch.no_grad():
        logits, _ = forward_train(mcfg, mparams, mtoks)
    assert logits.shape == (1, 8, mcfg.vocab_padded)
    gparams = init_params(cfg, seed=0, device=cuda)
    feats = pooled_features(cfg, gparams, torch.zeros((1, 8), dtype=torch.int64, device=cuda))
    assert feats.shape == (1, cfg.d_model) and not feats.requires_grad


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "whisper-tiny"])
def test_moe_and_encdec_prefill_and_decode_on_card(cuda, arch):
    """Reduced qwen3-moe and kimi-k2 (their dispatch and expert products on
    the card, K3 once a layer) and whisper (K3 over 64 frames in every
    encoder layer, causal in every decoder layer, non-causal in every
    cross-attention): the card's prefill and decode steps against the CPU's."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    gparams = _on(params, cuda)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 90)))
    side = None
    if cfg.is_encoder_decoder:
        side = torch.from_numpy(embedding_side_inputs("audio", 2, cfg.d_model,
                                                      frames=cfg.enc_frames))
    per_prefill = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers if side is not None else 0)
    before = flash_kernel.flash_attention.launches
    last, cache = prefill(cfg, gparams, toks.to(cuda), None if side is None else side.to(cuda),
                          extra_len=8)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention.launches == before + per_prefill
    want, wcache = prefill(cfg, params, toks, side, extra_len=8)
    torch.testing.assert_close(last.cpu(), want, atol=2e-4, rtol=0)
    if side is not None:
        for (k, _), (wk, _) in zip(cache.cross, wcache.cross):
            torch.testing.assert_close(k.cpu(), wk, atol=2e-5, rtol=0)
    before = flash_kernel.flash_attention.launches
    for t in (3, 17, 29):
        tok = torch.tensor([t, t + 1])
        out, cache = decode_step(cfg, gparams, tok.to(cuda), cache)
        wout, wcache = decode_step(cfg, params, tok, wcache)
        torch.testing.assert_close(out.cpu(), wout, atol=5e-4, rtol=0)
    assert flash_kernel.flash_attention.launches == before
