"""The port's LM examples against the JAX examples, on the CPU:
examples/torch/serve_batch.py (the LM demo, gemma3-1b and mamba2-780m
reduced), serve_stream.py --interleave (qwen1.5-4b reduced) and
train_lm_mtl.py, each beside its twin in examples/.

The two packages draw other numbers from one seed, so the port's
``init_params`` is swapped for JAX's draw carried across
(``convert.lm_params_from_reference``): ``repro_torch.models.init_params``
for the serving demos, ``train.loop.init_params`` for training, as
tests/test_torch_train_loop.py does. Bars: greedy tokens equal up to
JAX's first id past the real vocabulary (the port ranks only real ids);
the interleaved stream's virtual-clock times, counts and occupancy
equal; training losses at rtol 1e-3 and the params after it at atol 5e-3
(tests/test_torch_train_loop.py's bars), the heads' test error within
one test sample of one task and the covariance diagonal at the Sigma
fit bar (1e-5). A printed number is held within its bar plus half a unit
of its last printed digit.
"""
import re

import jax
import numpy as np
import pytest
import torch

import repro.train
import repro_torch.models
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.convert import lm_params_from_reference
from repro_torch.train import loop
from repro_torch.train.optimizer import tree_map
from torch_examples_util import (
    NUMBER,
    assert_printed_close,
    grab,
    port_example,
    run_jax_example,
)

TOL_SIGMA = 1e-5  # the fit bar on Sigma (tests/test_distributed.py)
TOL_LOSS, TOL_PARAM = 1e-3, 5e-3  # tests/test_torch_train_loop.py


def carry_jax_init(monkeypatch, target, arch):
    """``target.init_params(cfg, seed, device)`` returns JAX's
    ``init_params(cfg, PRNGKey(seed))`` of ``arch`` reduced, carried
    across."""
    jcfg = jax_get_config(arch).reduced()

    def init(cfg, seed, device):
        assert cfg.name == jcfg.name, (cfg.name, jcfg.name)
        jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
        return lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp), device=device)

    monkeypatch.setattr(target, "init_params", init)


def tokens_of(text):
    return [[int(t) for t in body.split(", ")]
            for body in re.findall(r"req\d+: prompt\[\d+ toks\] -> \[([^\]]*)\]", text)]


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
def test_serve_batch_lm_matches_jax(arch, monkeypatch, capsys):
    carry_jax_init(monkeypatch, repro_torch.models, arch)
    text = run_jax_example("serve_batch.py", ["--arch", arch], monkeypatch, capsys)
    out = port_example("serve_batch").main(["--arch", arch, "--device", "cpu"])
    want = tokens_of(text)
    vocab = jax_get_config(arch).reduced().vocab_size
    assert len(want) == len(out["outputs"]) == 3
    for w, got in zip(want, out["outputs"]):
        cut = next((i for i, t in enumerate(w) if t >= vocab), len(w))
        assert got[:cut] == w[:cut]
        if cut == len(w):
            assert got == w
    assert out["prompt_lens"] == [5, 9, 3]
    assert out["launches"] == {"K3": 0, "K3-bwd": 0, "K4": 0, "K4-bwd": 0}  # no card


def test_interleave_matches_jax(monkeypatch, capsys):
    carry_jax_init(monkeypatch, repro_torch.models, "qwen1_5-4b")
    text = run_jax_example("serve_stream.py", ["--tiny", "--interleave"], monkeypatch, capsys)
    out = port_example("serve_stream").main(["--tiny", "--interleave", "--device", "cpu"])
    buckets, = grab(r"prefill buckets \[([^\]]*)\]", text)
    assert [int(b) for b in buckets.split(", ")] == out["buckets"]
    done = re.findall(rf"\[ *({NUMBER})s\] (long|short) *done: (\d+) tokens, ttft (\d+)ms, "
                      r"latency (\d+)ms", text)
    assert len(done) == len(out["finished"]) == 7
    for (t, kind, n, ttft, lat), f in zip(done, out["finished"]):
        assert (kind, int(n)) == (f["kind"], f["tokens"])
        assert_printed_close(t, f["t_s"], 0.0, "finish time")
        assert_printed_close(ttft, f["ttft_ms"], 0.0, "ttft")
        assert_printed_close(lat, f["latency_ms"], 0.0, "latency")
    completed, steps, occ = grab(rf"served (\d+) requests in (\d+) decode steps, slot occupancy "
                                 rf"({NUMBER})", text)
    assert (int(completed), int(steps)) == (out["completed"], out["decode_steps"])
    assert_printed_close(occ, out["slot_occupancy"], 0.0, "occupancy")
    p50, p99 = grab(r"ttft p50/p99: (\d+) / (\d+) ms", text)
    assert_printed_close(p50, out["ttft_p50_ms"], 0.0, "ttft p50")
    assert_printed_close(p99, out["ttft_p99_ms"], 0.0, "ttft p99")
    short, long_ = grab(r"short-request max latency (\d+)ms vs longest generation (\d+)ms", text)
    assert_printed_close(short, out["short_max_latency_ms"], 0.0, "short max")
    assert_printed_close(long_, out["long_max_latency_ms"], 0.0, "long max")
    assert out["short_max_latency_ms"] < out["long_max_latency_ms"]


def test_train_lm_mtl_matches_jax(monkeypatch, capsys):
    """Two steps of reduced gemma3-1b from JAX's params on the same batches,
    then the DMTRL heads on its features. Each side's ``train`` is wrapped
    to keep the params it returns."""
    args = ["--steps", "2", "--batch", "2", "--seq", "16"]
    trained = {}

    def keep(name, fn):
        def run(*a, **kw):
            trained[name] = out = fn(*a, **kw)
            return out
        return run

    monkeypatch.setattr(repro.train, "train", keep("jax", repro.train.train))
    carry_jax_init(monkeypatch, loop, "gemma3-1b")
    text = run_jax_example("train_lm_mtl.py", args, monkeypatch, capsys)
    mod = port_example("train_lm_mtl")
    monkeypatch.setattr(mod, "train", keep("port", mod.train))
    out = mod.main([*args, "--device", "cpu"])

    steps = re.findall(rf"step +(\d+)  loss ({NUMBER})", text)
    assert [int(s) for s, _ in steps] == list(range(len(out["losses"])))
    for (_, loss), got in zip(steps, out["losses"]):
        assert_printed_close(loss, got, TOL_LOSS * abs(got), "loss")
    l0, l1 = grab(rf"loss ({NUMBER}) -> ({NUMBER})", text)
    assert_printed_close(l0, out["loss_first"], TOL_LOSS * abs(out["loss_first"]), "first loss")
    assert_printed_close(l1, out["loss_last"], TOL_LOSS * abs(out["loss_last"]), "last loss")
    params = tree_map(lambda t: t.detach().numpy(), trained["port"][0])
    jparams = jax.tree.map(np.asarray, trained["jax"][0])
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(leaves) == len(jax.tree_util.tree_leaves(params))
    for path, want in leaves:
        got = params
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_allclose(got, want, atol=TOL_PARAM, rtol=0, err_msg=str(path))

    phi, = grab(r"phi dim = (\d+)", text)
    assert int(phi) == out["phi_dim"]
    err, = grab(rf"test error: ({NUMBER})", text)
    assert_printed_close(err, out["test_error"], 1.0 / (6 * min(out["n_test"])), "test error")
    diag, = grab(r"covariance diag: \[([^\]]*)\]", text)
    diag = diag.split()
    assert len(diag) == len(out["sigma_diag"]) == 6
    for p, v in zip(diag, out["sigma_diag"]):
        assert_printed_close(p, v, TOL_SIGMA, "Sigma diagonal")


@pytest.mark.parametrize("name, args", [
    ("serve_batch", []),
    ("serve_stream", ["--tiny", "--interleave"]),
    ("train_lm_mtl", ["--steps", "1"]),
])
def test_runs_on_the_card_unless_asked(name, args, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mod = port_example(name)
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(args)
    assert capsys.readouterr().out == ""  # raised before any work
