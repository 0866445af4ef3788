"""The port's streaming scheduler over the LM ServingEngine, on the CPU:
tests/test_serve_decode.py against ``repro_torch.serve``.

The scripted tests drive the slot machinery through stubbed ``_prefill_one``
/ ``_step_call`` hooks (deterministic token streams, no model) behind
``ContinuousBatchingScheduler``: slot recycling, a publish between decode
steps, the retry reset, a failed decode step requeued, and the engine's
guards. The model tests run the reduced qwen1.5-4b (JAX params carried
across) through bucketed, pad-masked prefill and per-slot decode behind the
scheduler: batched and mid-decode-admitted generations equal solo ones
token for token, and the solo ones equal the JAX engine's.
"""
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
from repro_torch.serve import (
    ContinuousBatchingScheduler,
    ModelSnapshot,
    Request,
    ServeConfig,
    ServingEngine,
    VirtualClock,
)

ARCH = "qwen1_5-4b"


# ---------------------------------------------------------------------------
# scripted slot engine (no model): token[t][slot] per decode boundary t
# ---------------------------------------------------------------------------
def _slot_scripted_engine(token_rows, batch=2, eos_id=1):
    """ServingEngine whose hooks emit ``token_rows[t][slot]`` at global
    decode boundary t. The clock does NOT reset on prefill, so requests
    injected into recycled slots mid-decode read the CURRENT script row
    (their first token) while older slots keep advancing."""
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


def _req(budget):
    return Request(prompt=np.array([4], np.int32), max_new_tokens=budget)


def test_slot_recycling_no_drops_no_double_finish():
    """Four requests stream through two slots: EOS and budget stops free
    slots mid-run, later requests are injected into the RUNNING batch,
    every request finishes exactly once with the scripted tokens."""
    #               t=0     t=1     t=2     t=3
    script = [[5, 6], [7, 8], [9, 1], [2, 3]]
    eng = _slot_scripted_engine(script)
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock(), policy="fifo")
    r0, r1, r2, r3 = _req(3), _req(2), _req(2), _req(2)
    sched.submit_many([r0, r1, r2, r3])

    done = []
    steps = 0
    while (sched.pending or sched.in_flight) and steps < 50:
        done += sched.step()
        steps += 1
    assert len(done) == 4 and len({id(r) for r in done}) == 4
    assert all(r.status == "done" and r.done for r in done)
    # slot0: r0 runs to budget while slot1 turns over r1 -> r2 -> r3
    assert r0.output == [5, 7, 9] and r0.finish_reason == "length"
    assert r1.output == [6, 8] and r1.finish_reason == "length"
    assert r2.output == [8, 1] and r2.finish_reason == "eos"  # EOS recycle
    assert r3.output == [1] and r3.finish_reason == "eos"  # EOS at prefill
    assert eng.free_slots == eng.batch and eng.active == 0
    m = sched.metrics
    assert m.ttft.count == 4 and m.completed == 4
    assert m.decode_steps == 3 and 0.0 < m.slot_occupancy() <= 1.0
    # a long generation never head-of-line-blocks a short one
    assert r1.finish_s <= r0.finish_s


def test_mid_decode_publish_isolation():
    """A publish landing between decode steps must not relabel in-flight
    requests: they complete on the snapshot they were ADMITTED under."""
    script = [[5, 6], [7, 8], [9, 2], [3, 4]]
    eng = _slot_scripted_engine(script)
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock(), policy="fifo")
    a, b = _req(3), _req(3)
    sched.submit_many([a, b])
    sched.step()  # inject on v0 + one decode step (nobody finished)
    assert a.status == "running" and sched.in_flight == 2
    sched.publish(ModelSnapshot(version=5))  # mid-generation hot-swap
    late = _req(1)
    sched.submit(late)
    assert sched.run_until_idle() == 3
    assert a.snapshot_version == 0 and b.snapshot_version == 0
    assert late.snapshot_version == 5
    assert sched.metrics.swaps == 1


def test_retry_resets_per_attempt_decode_state():
    """A request evicted after a failed decode keeps no stale output: the
    re-inject resets output/done/finish_reason, so the retry emits the
    scripted stream exactly once (no double-append)."""
    script = [[5, 6], [7, 8], [9, 2], [3, 4]]
    eng = _slot_scripted_engine(script)
    snap = eng.model_snapshot()
    r = _req(3)
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


def test_scheduler_requeues_streaming_engine_failure():
    """A decode-step crash evicts the whole slot table back to the queue
    head; the rerun completes everything with exact budget lengths."""
    script = [[5, 6], [7, 8], [9, 2], [3, 4], [5, 6]]
    eng = _slot_scripted_engine(script)
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock(), policy="fifo")
    reqs = [o.request for o in sched.submit_many([_req(3) for _ in range(2)])]
    good_step = eng._step_call

    def boom(token, cache):
        raise RuntimeError("device fell over")

    eng._step_call = boom
    with pytest.raises(RuntimeError, match="fell over"):
        sched.step()
    assert sched.pending == 2 and sched.in_flight == 0
    assert all(r.status == "queued" for r in reqs)
    eng._step_call = good_step
    assert sched.run_until_idle() == 2
    for r in reqs:
        assert r.status == "done" and len(r.output) == 3  # no stale tokens


def test_inject_overflow_and_blocking_run_guards():
    eng = _slot_scripted_engine([[5, 6], [7, 8]])
    snap = eng.model_snapshot()
    reqs = [_req(8) for _ in range(3)]
    with pytest.raises(RuntimeError, match="free slots"):
        eng.inject(reqs, snap)
    eng.inject(reqs[:2], snap)
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.run([_req(1)])


# ---------------------------------------------------------------------------
# the reduced qwen1.5-4b: bucketed pad-masked prefill + per-slot decode
# ---------------------------------------------------------------------------
_MODEL = {}


def qwen():
    """(cfg, params, jcfg, jparams), built once per process."""
    if not _MODEL:
        cfg, jcfg = get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
        params = lm_params_from_reference(cfg, jax.tree.map(np.asarray, jparams),
                                          device="cpu")
        _MODEL["qwen"] = (cfg, params, jcfg, jparams)
    return _MODEL["qwen"]


def _solo(cfg, params, prompt, budget, bucket_min=8):
    eng = ServingEngine(cfg, params, ServeConfig(batch=1, max_len=64, bucket_min=bucket_min),
                        device="cpu")
    r = Request(prompt=np.asarray(prompt, np.int32), max_new_tokens=budget)
    eng.run([r])
    return r.output


def _jax_solo(prompt, budget, bucket_min=8):
    _, _, jcfg, jparams = qwen()
    eng = JaxServingEngine(jcfg, jparams,
                           JaxServeConfig(batch=1, max_len=64, bucket_min=bucket_min))
    r = JaxRequest(prompt=np.asarray(prompt, np.int32), max_new_tokens=budget)
    eng.run([r])
    return r.output


def test_bucketed_pad_prefill_batched_equals_solo():
    """Prompts of length 3 and 7 share the padded length-8 bucket; the pad
    mask makes their batched generations equal to solo runs, and the solo
    runs equal the JAX engine's."""
    cfg, params, _, _ = qwen()
    p_short, p_long = [3, 5, 7], [2, 4, 6, 8, 10, 12, 14]
    solo_s = _solo(cfg, params, p_short, 6)
    solo_l = _solo(cfg, params, p_long, 6)
    assert solo_s == _jax_solo(p_short, 6) and solo_l == _jax_solo(p_long, 6)
    eng = ServingEngine(cfg, params, ServeConfig(batch=2, max_len=64, bucket_min=8),
                        device="cpu")
    assert eng._bucket_for(3) == eng._bucket_for(7) == 8  # one shared bucket
    rs = Request(prompt=np.asarray(p_short, np.int32), max_new_tokens=6)
    rl = Request(prompt=np.asarray(p_long, np.int32), max_new_tokens=6)
    eng.run([rs, rl])
    assert rs.output == solo_s and rl.output == solo_l


def test_mid_decode_admission_bit_equal_to_solo():
    """A request injected through the scheduler while the other slots are
    mid-generation decodes the same tokens it would decode alone."""
    cfg, params, _, _ = qwen()
    prompts = [[3, 5, 7], [11, 13], [2, 4, 6, 8, 10]]
    budgets = [8, 5, 6]
    solo = [_solo(cfg, params, p, b) for p, b in zip(prompts, budgets)]
    eng = ServingEngine(cfg, params, ServeConfig(batch=2, max_len=64, bucket_min=8,
                                                 drain_every=2), device="cpu")
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock(), policy="fifo")
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    sched.submit_many(reqs[:2])
    sched.step()
    sched.step()  # two decode steps in, slots busy
    sched.submit(reqs[2])  # arrives mid-decode, waits for an EOS/budget slot
    sched.run_until_idle()
    assert [r.output for r in reqs] == solo
    for r in reqs:
        assert r.first_token_s is not None and r.ttft_s <= r.latency_s
