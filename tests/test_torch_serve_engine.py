"""Port's LM ServingEngine against the JAX package's, on the CPU.

The model test drives both engines over the reduced zamba2 (JAX params
carried across) with batch 2 and three prompts of different lengths, so
the third request enters a recycled slot: greedy token streams and finish
reasons must be identical. The scripted tests drive the slot machinery
through stubbed ``_prefill_one`` / ``_step_call`` hooks, as
tests/test_serve_decode.py does (no model).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.tokens import embedding_side_inputs
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.serve.engine import _next_bucket

ARCH = "zamba2-2_7b"


def _stream(engine, make_request, prompts, budgets):
    """Inject two requests, tick, inject the third into the first freed
    slot; returns (output, finish_reason) per request."""
    reqs = [make_request(prompt=p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    for r in reqs:
        engine.admit(r)
    engine.inject(reqs[:2])
    pending, done = [reqs[2]], []
    while len(done) < len(reqs):
        done += engine.decode_tick()
        if pending and engine.free_slots:
            engine.inject(pending)
            pending = []
    return [(r.output, r.finish_reason) for r in reqs]


@pytest.mark.parametrize("eos_id", [1, None])
def test_engine_matches_jax_engine(eos_id):
    cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rs = np.random.RandomState(1)
    prompts = [rs.randint(2, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 21, 5)]
    budgets = [6, 3, 5]
    probe_eos = eos_id is None
    if probe_eos:  # make the first request's second token its EOS
        probe = JaxServingEngine(jcfg, jparams, JaxServeConfig(batch=1, max_len=48))
        r = JaxRequest(prompt=prompts[0], max_new_tokens=2)
        probe.run([r])
        eos_id = r.output[1]
    jax_out = _stream(
        JaxServingEngine(jcfg, jparams, JaxServeConfig(batch=2, max_len=48, eos_id=eos_id)),
        JaxRequest, prompts, budgets,
    )
    out = _stream(
        ServingEngine(cfg, params, ServeConfig(batch=2, max_len=48, eos_id=eos_id), device="cpu"),
        Request, prompts, budgets,
    )
    assert out == jax_out
    assert all(reason in ("eos", "length") for _, reason in out)
    if probe_eos:
        assert out[0] == (out[0][0][:2], "eos")


def _reduced_pair(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if arch == "gemma3-1b":  # 6 layers: five local ones and a global one
        cfg, jcfg = (dataclasses.replace(c, n_layers=6) for c in (cfg, jcfg))
    return cfg, jcfg


@pytest.mark.parametrize("arch", ["qwen1_5-4b", "mamba2-780m", "gemma3-1b"])
def test_dense_and_ssm_engines_match_jax_engine(arch):
    """A dense arch (bucketed, pad-masked prefill into a stacked uniform
    cache), the pure SSM (exact-length prefill) and gemma3 (local ring
    buffers, decoded past the window of 32): the same greedy streams as
    the JAX engine, the third request in a recycled slot."""
    cfg, jcfg = _reduced_pair(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rs = np.random.RandomState(2)
    prompts = [rs.randint(2, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 21, 5)]
    budgets = [6, 3, 40] if arch == "gemma3-1b" else [6, 3, 5]
    scfg = dict(batch=2, max_len=64, bucket_min=8, eos_id=-1)
    jax_out = _stream(JaxServingEngine(jcfg, jparams, JaxServeConfig(**scfg)), JaxRequest,
                      prompts, budgets)
    eng = ServingEngine(cfg, params, ServeConfig(**scfg), device="cpu")
    out = _stream(eng, Request, prompts, budgets)
    assert out == jax_out
    assert [len(o) for o, _ in out] == budgets
    assert isinstance(eng._cache.layers, dict) == (arch != "gemma3-1b")


def _own_loop(cfg, params, prompt, n_new, side=None):
    """Greedy tokens of one request through the port's own exact-length
    prefill and decode steps, without the engine."""
    sd = None if side is None else torch.from_numpy(side[None])
    logits, cache = prefill(cfg, params, torch.from_numpy(prompt[None]), sd, extra_len=n_new)
    out = [int(torch.argmax(logits[0]))]
    while len(out) < n_new:
        logits, cache = decode_step(cfg, params, torch.tensor([out[-1]]), cache)
        out.append(int(torch.argmax(logits[0])))
    return out, cache


def _zoo_requests(cfg, seed):
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(2, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 21, 5)]
    frames = (embedding_side_inputs("audio", 3, cfg.d_model, seed=seed, frames=cfg.enc_frames)
              if cfg.is_encoder_decoder else None)
    return prompts, frames


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "whisper-tiny"])
def test_moe_and_encdec_run_matches_the_own_loop(arch):
    """ServingEngine.run over the reduced MoE (bucketed prefill at the
    lossless capacity) and the reduced whisper (exact length; frames given
    to run() stacked): each request's greedy tokens are those of its own
    prefill + decode loop."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    prompts, frames = _zoo_requests(cfg, 3)
    budgets = [6, 3, 5]
    eng = ServingEngine(cfg, params, ServeConfig(batch=3, max_len=64, bucket_min=8, eos_id=-1),
                        device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    eng.run(reqs, side=frames)
    for i, r in enumerate(reqs):
        side = None if frames is None else frames[i]
        assert r.output == _own_loop(cfg, params, prompts[i], budgets[i], side)[0], i
        assert r.finish_reason == "length"
    assert eng._maskable == (not cfg.is_encoder_decoder)


def test_encdec_cross_cache_survives_the_slot_insert():
    """Whisper behind a batch of 2: the third request enters the slot the
    second one freed; that slot's cross k/v are then the third request's
    own (the first's stay in place), and every stream equals its own
    loop."""
    cfg = get_config("whisper-tiny").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    prompts, frames = _zoo_requests(cfg, 4)
    budgets = [8, 2, 4]
    eng = ServingEngine(cfg, params, ServeConfig(batch=2, max_len=64, eos_id=-1), device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=b, side=f)
            for p, b, f in zip(prompts, budgets, frames)]
    with pytest.raises(ValueError, match="side frames"):
        eng.admit(Request(prompt=prompts[0], max_new_tokens=2))
    for r in reqs:
        eng.admit(r)
    eng.inject(reqs[:2])

    def slot_of(r):  # by identity: requests compare their arrays
        return next(i for i, q in enumerate(eng._slots) if q is r)

    first_slot = slot_of(reqs[0])
    while not eng.free_slots:
        eng.decode_tick()
    assert reqs[1].done and not reqs[0].done
    eng.inject(reqs[2:])
    slot = slot_of(reqs[2])
    assert slot != first_slot
    for i, s in ((2, slot), (0, first_slot)):
        _, own = prefill(cfg, params, torch.from_numpy(prompts[i][None]),
                         torch.from_numpy(frames[i][None]), extra_len=1)
        for (k, v), (ok, ov) in zip(eng._cache.cross, own.cross):
            assert tuple(k.shape) == (2,) + tuple(ok.shape[1:]) and k.dtype == ok.dtype
            torch.testing.assert_close(k[s], ok[0], atol=0, rtol=0)
            torch.testing.assert_close(v[s], ov[0], atol=0, rtol=0)
    while not all(r.done for r in reqs):
        eng.decode_tick()
    for i, r in enumerate(reqs):
        assert r.output == _own_loop(cfg, params, prompts[i], budgets[i], frames[i])[0], i


def test_encdec_warmup_waits_for_the_first_prefill():
    """As in the JAX engine, an encoder-decoder's warmup allocates no batch
    state: its cross k/v take the dtype the frames promote to."""
    cfg = get_config("whisper-tiny").reduced()
    eng = ServingEngine(cfg, None, ServeConfig(batch=2, max_len=64, bucket_min=8), device="cpu")
    assert eng.warmup([8, 16]) == [8, 16]
    assert eng._cache is None


def test_greedy_samples_the_real_vocabulary():
    """The logits cover the padded vocabulary; a pad column that would win
    the argmax is never sampled (the tokens are those of the real
    vocabulary's argmax)."""
    cfg = dataclasses.replace(get_config("qwen1_5-4b").reduced(), vocab_size=1000)
    assert cfg.vocab_padded == 1024
    params = init_params(cfg, seed=0, device="cpu")
    prompt = np.arange(2, 12, dtype=np.int32)
    logits, _ = prefill(cfg, params, torch.from_numpy(prompt[None]))
    best = int(torch.argmax(logits[0, :1000]))
    assert float(logits[0, best]) > 0
    # the pad columns: twice the winning column, so a pad id wins the argmax
    params["lm_head"][:, 1000:] = 2.0 * params["lm_head"][:, best:best + 1]
    eng = ServingEngine(cfg, params, ServeConfig(batch=1, max_len=32, eos_id=-1), device="cpu")
    r = Request(prompt=prompt, max_new_tokens=4)
    eng.run([r])
    logits, cache = prefill(cfg, params, torch.from_numpy(prompt[None]), extra_len=4)
    assert int(torch.argmax(logits[0])) >= 1000
    want = [int(torch.argmax(logits[0, :1000]))]
    while len(want) < 4:
        logits, cache = decode_step(cfg, params, torch.tensor([want[-1]]), cache)
        want.append(int(torch.argmax(logits[0, :1000])))
    assert r.output == want and all(t < 1000 for t in r.output)


# ---------------------------------------------------------------------------
# scripted slot engine (no model): token[t][slot] per decode boundary t
# ---------------------------------------------------------------------------
def _slot_scripted_engine(token_rows, batch=2, eos_id=1):
    """ServingEngine whose hooks emit ``token_rows[t][slot]`` at global
    decode boundary t (the clock does not reset on prefill)."""
    eng = ServingEngine(
        get_config(ARCH).reduced(), None,
        ServeConfig(batch=batch, max_len=256, eos_id=eos_id, drain_every=1),
        device="cpu",
    )
    script = np.asarray(token_rows, np.int32)  # (T, B)
    vocab = int(script.max()) + 2
    t = {"now": 0}

    def logits_at(tt):
        z = np.full((batch, vocab), -10.0, np.float32)
        z[np.arange(batch), script[min(tt, script.shape[0] - 1)]] = 10.0
        return torch.from_numpy(z)

    def fake_prefill_one(r):
        slot = eng._free[-1]
        return logits_at(t["now"])[slot : slot + 1], torch.zeros(())

    def fake_step(token, cache):
        t["now"] += 1
        return logits_at(t["now"]), cache

    eng._prefill_one = fake_prefill_one
    eng._step_call = fake_step
    return eng


def test_retry_resets_per_attempt_decode_state():
    """A request evicted after a failed decode keeps no stale output: the
    re-inject resets output/done/finish_reason, so the retry emits the
    scripted stream exactly once (no double-append)."""
    script = [[5, 6], [7, 8], [9, 2], [3, 4]]
    eng = _slot_scripted_engine(script)
    snap = eng.model_snapshot()
    r = Request(prompt=np.array([4], np.int32), max_new_tokens=3)
    eng.inject([r], snap)
    eng.decode_tick()
    assert r.output == [5, 7] and not r.done  # partial attempt drained
    evicted = eng.evict_active()  # simulated tile failure
    assert evicted == [r] and eng.free_slots == eng.batch
    eng.inject([r], snap)  # retry: per-attempt state reset
    while not r.done:
        eng.decode_tick()
    # the retry re-prefills at the current boundary (t=1) and streams fresh
    assert r.output == [7, 9, 3]
    assert len(r.output) == r.max_new_tokens and r.finish_reason == "length"


def test_inject_overflow_and_blocking_run_guards():
    script = [[5, 6], [7, 8]]
    eng = _slot_scripted_engine(script)
    snap = eng.model_snapshot()
    reqs = [Request(prompt=np.array([4], np.int32), max_new_tokens=8) for _ in range(3)]
    with pytest.raises(RuntimeError, match="free slots"):
        eng.inject(reqs, snap)
    eng.inject(reqs[:2], snap)
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.run([Request(prompt=np.array([4], np.int32), max_new_tokens=1)])


def test_slot_recycling_with_eos():
    """Slot 1 turns over three requests (budget, EOS, EOS at prefill) while
    slot 0 runs to its budget; every request finishes exactly once."""
    script = [[5, 6], [7, 8], [9, 1], [2, 3]]
    eng = _slot_scripted_engine(script)
    r0, r1, r2, r3 = (Request(prompt=np.array([4], np.int32), max_new_tokens=n)
                      for n in (3, 2, 2, 2))
    eng.inject([r0, r1])
    done = []
    queue = [r2, r3]
    while len(done) < 4:
        done += eng.decode_tick()
        while queue and eng.free_slots:
            eng.inject([queue.pop(0)])
    assert len({id(r) for r in done}) == 4
    assert r0.output == [5, 7, 9] and r0.finish_reason == "length"
    assert r1.output == [6, 8] and r1.finish_reason == "length"
    assert r2.output == [8, 1] and r2.finish_reason == "eos"
    assert r3.output == [1] and r3.finish_reason == "eos"
    assert eng.free_slots == eng.batch and eng.active == 0


def test_admission_and_config_guards():
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, None, ServeConfig(batch=1, max_len=16), device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.admit(Request(prompt=np.arange(10, dtype=np.int32), max_new_tokens=7))
    with pytest.raises(ValueError, match="integer"):
        eng.admit(Request(prompt=np.ones(3, np.float32), max_new_tokens=1))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServingEngine(cfg, None, ServeConfig(temperature=0.7), device="cpu")
    assert [_next_bucket(n, 16, 1023) for n in (1, 16, 17, 600, 1023)] == [16, 16, 32, 1023, 1023]


def test_warmup_allocates_the_batch_state():
    cfg = get_config(ARCH).reduced()
    eng = ServingEngine(cfg, None, ServeConfig(batch=3, max_len=64, bucket_min=8), device="cpu")
    assert eng.warmup() == [8, 16, 32]
    cache = eng._cache
    assert tuple(cache.position.shape) == (3,)
    assert len(cache.layers) == cfg.n_layers and len(cache.shared) == 2
    assert tuple(cache.shared[0]["k"].shape) == (3, 64, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(eng._token.shape) == (3,)
    with pytest.raises(ValueError, match="no decode room"):
        eng.warmup([64])


def test_warmup_allocates_the_stacked_cache_of_a_uniform_arch():
    """A uniform arch's batch cache keeps the stacked (n_layers, B, ...)
    layout: the batch axis is 1 there, and the slot insert writes it."""
    cfg = get_config("qwen1_5-4b").reduced()
    eng = ServingEngine(cfg, None, ServeConfig(batch=3, max_len=64, bucket_min=8), device="cpu")
    eng.warmup([8])
    k = eng._cache.layers["k"]
    assert tuple(k.shape) == (cfg.n_layers, 3, 64, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(eng._cache.position.shape) == (3,)
