"""The port's batched MTL scoring engine (repro_torch/serve/mtl.py) against
the JAX package's, on the scenarios of tests/test_serve_mtl.py: the same
W and requests through both engines, scores within 1e-5.

The CPU cases run the plain step (there is no graph to capture). The
``gpu`` cases (skipped here) hold the CUDA-graph replay against the eager
step on the card, a publish between replays, an in-flight tile's packed W
and one capture shared by adopting engines:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_serve_mtl.py

The JAX package is imported inside the parity tests only, so the file
also imports on the card, where JAX is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import DMTRLConfig, DMTRLEstimator
from repro_torch.data.synthetic import synthetic
from repro_torch.serve import (
    ContinuousBatchingScheduler,
    ModelSnapshot,
    MTLScoringEngine,
    ScoreRequest,
    VirtualClock,
)
from repro_torch.serve import mtl as mtl_mod

TOL = 1e-5


@pytest.fixture(scope="module")
def W():
    return np.random.RandomState(0).randn(5, 12).astype(np.float32)


def _requests(tasks, d=12, seed=1, cls=ScoreRequest):
    rng = np.random.RandomState(seed)
    return [cls(task=int(t), x=rng.randn(d).astype(np.float32)) for t in tasks]


def _engine(W, **kw):
    return MTLScoringEngine(W, device="cpu", **kw)


@pytest.fixture(scope="module")
def port_problem():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)


@pytest.fixture(scope="module")
def port_cfg(small_cfg):
    return DMTRLConfig(**dataclasses.asdict(small_cfg))


# ---------------------------------------------------------------------------
# the same requests through the JAX engine and the port's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,tasks", [(4, (0, 3, 4, 1, 2, 0, 4)), (3, (0, 1, 2)),
                                         (2, (4,)), (5, tuple(range(5)) * 3)])
@pytest.mark.parametrize("classify", [True, False])
def test_run_matches_jax(W, batch, tasks, classify):
    from repro.serve import MTLScoringEngine as JaxEngine, ScoreRequest as JaxRequest

    jreqs = _requests(tasks, cls=JaxRequest)
    treqs = _requests(tasks)
    JaxEngine(W, batch=batch, classify=classify).run(jreqs)
    done = _engine(W, batch=batch, classify=classify).run(treqs)
    assert done is treqs
    for j, t in zip(jreqs, treqs):
        assert t.score == pytest.approx(j.score, abs=TOL)
        assert t.label == j.label
        assert t.score == pytest.approx(float(t.x @ W[t.task]), abs=TOL)


@pytest.mark.parametrize("n", [6, 7, 3, 0])  # n % batch == 0, == 1, == n, empty
def test_score_batch_matches_jax(W, n):
    from repro.serve import MTLScoringEngine as JaxEngine

    rng = np.random.RandomState(n)
    X = rng.randn(n, 12).astype(np.float32)
    t = (np.arange(n) % 5).astype(np.int32)
    zj = JaxEngine(W, batch=3).score_batch(X, t)
    zt = _engine(W, batch=3).score_batch(X, t)
    assert zt.shape == zj.shape == (n,) and zt.dtype == np.float32
    np.testing.assert_allclose(zt, zj, atol=TOL)
    # scalar task broadcast and tensor inputs
    if n:
        np.testing.assert_allclose(_engine(W, batch=3).score_batch(torch.from_numpy(X), 2),
                                   X @ W[2], atol=TOL)


def test_regression_mode_has_no_labels(W):
    r = _engine(W, batch=2, classify=False).run(
        [ScoreRequest(task=0, x=np.ones(12, np.float32))])[0]
    assert r.score is not None and r.label is None


def test_request_validation(W):
    eng = _engine(W, batch=2)
    with pytest.raises(ValueError, match="task id"):
        eng.run([ScoreRequest(task=7, x=np.zeros(12, np.float32))])
    with pytest.raises(ValueError, match="feature shape"):
        eng.run([ScoreRequest(task=0, x=np.zeros(3, np.float32))])
    with pytest.raises(ValueError, match="task id"):
        eng.score_batch(np.zeros((2, 12), np.float32), np.array([-1, 0]))
    with pytest.raises(ValueError, match="feature shape"):
        eng.score_batch(np.zeros((2, 5), np.float32), 0)
    with pytest.raises(ValueError, match="batch"):
        _engine(W, batch=0)
    with pytest.raises(ValueError, match="W must be"):
        _engine(np.zeros(3))
    reqs = _requests((0, 0))
    reqs[1].x = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="stack"):
        eng.run(reqs)
    assert all(r.score is None for r in reqs)  # all-or-nothing
    assert eng.run([]) == []


def test_default_device_raises_without_a_card(W):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MTLScoringEngine(W)


def test_warmup_is_a_noop_on_the_cpu(W):
    eng = _engine(W, batch=4)
    eng.warmup()
    assert eng._graph is None
    assert not eng.adopt_warmup(_engine(W, batch=4))  # a cold donor


def test_float64_and_dtype_mismatched_w(W):
    """float64 W narrows to float32 (as jnp.asarray does); a bf16 W scores
    through the plain step with the dtypes promoted, as JAX promotes."""
    from repro.serve import MTLScoringEngine as JaxEngine

    X = np.random.RandomState(3).randn(4, 12).astype(np.float32)
    eng = _engine(W.astype(np.float64), batch=4)
    assert eng.W.dtype == torch.float32
    Wb = torch.from_numpy(W).bfloat16()
    z = _engine(Wb, batch=4).score_batch(X, [0, 1, 2, 3])
    zj = JaxEngine(Wb.float().numpy(), batch=4).score_batch(X, [0, 1, 2, 3])
    np.testing.assert_allclose(z, zj, atol=1e-4)


# ---------------------------------------------------------------------------
# hot-swap surface
# ---------------------------------------------------------------------------
def test_swap_publish_versions_match_jax(W):
    from repro.serve import MTLScoringEngine as JaxEngine, ModelSnapshot as JaxSnap

    W2 = np.random.RandomState(9).randn(*W.shape).astype(np.float32)
    x = np.ones((1, 12), np.float32)
    engs = (JaxEngine(W, batch=4, version=1), _engine(W, batch=4, version=1))
    for eng, Snap in zip(engs, (JaxSnap, ModelSnapshot)):
        assert eng.score_batch(x, 0)[0] == pytest.approx(float(x[0] @ W[0]), abs=TOL)
        assert eng.swap(W2) == 2 and eng.version == 2
        assert eng.score_batch(x, 0)[0] == pytest.approx(float(x[0] @ W2[0]), abs=TOL)
        assert eng.swap(W2, version=2) == 2  # duplicate delivery: no-op
        with pytest.raises(ValueError, match="not newer"):
            eng.swap(W2, version=1)
        assert eng.publish_weights(W, version=1) == 3  # restamped
        assert eng.publish(Snap(version=7, W=W2)) == 7
        with pytest.raises(ValueError, match="shape"):
            eng.publish(Snap(version=9, W=np.zeros((2, 2), np.float32)))
        with pytest.raises(RuntimeError, match="source"):
            eng.refresh()  # not built by an estimator
    assert isinstance(engs[1].W, torch.Tensor) and engs[1].version == engs[0].version == 7


def test_run_tile_scores_against_the_packed_snapshot(W):
    W2 = 2.0 * W
    eng = _engine(W, batch=4, version=1)
    old = eng.model_snapshot()
    eng.swap(W2)
    reqs = _requests((0, 1, 2))
    eng.run_tile(reqs, old)  # a tile packed before the swap
    for r in reqs:
        assert r.score == pytest.approx(float(r.x @ W[r.task]), abs=TOL)
    eng.run_tile(reqs, eng.model_snapshot())
    for r in reqs:
        assert r.score == pytest.approx(float(r.x @ W2[r.task]), abs=TOL)


# ---------------------------------------------------------------------------
# estimator wiring (the stale-weights footgun, the scheduler, the push)
# ---------------------------------------------------------------------------
def test_estimator_scoring_engine_matches_jax(small_problem, small_cfg, port_problem, port_cfg):
    from repro.core import DMTRLEstimator as JaxEstimator
    from repro.serve import ScoreRequest as JaxRequest

    je = JaxEstimator(engine="reference", config=small_cfg).fit(small_problem.train)
    te = DMTRLEstimator(config=port_cfg, device="cpu").fit(port_problem.train)
    x = np.asarray(small_problem.test.x[1, 0])
    rj = je.scoring_engine(batch=3).run([JaxRequest(task=1, x=x)])[0]
    eng = te.scoring_engine(batch=3)
    assert eng.device == torch.device("cpu") and eng.version == 1
    rt = eng.run([ScoreRequest(task=1, x=x)])[0]
    assert rt.score == pytest.approx(rj.score, abs=TOL)
    assert rt.score == pytest.approx(float(te.decision_function(x, tasks=1)[0]), abs=1e-6)
    assert rt.label == rj.label


def test_scoring_engine_tracks_partial_fit(port_problem, port_cfg):
    est = DMTRLEstimator(config=port_cfg, device="cpu").fit(port_problem.train)
    eng = est.scoring_engine(batch=3)
    v1, W1 = eng.version, est.W_.clone()
    x = port_problem.test.x[1, 0].numpy()
    est.partial_fit(port_problem.train)
    assert eng.version == v1 + 1  # snapshot pushed on install
    assert not torch.allclose(est.W_, W1)
    z = eng.run([ScoreRequest(task=1, x=x)])[0].score
    assert z == pytest.approx(float(est.decision_function(x, tasks=1)[0]), abs=1e-6)
    assert eng.refresh() == eng.version  # already current: no-op


def test_serving_scheduler_hot_swaps_on_partial_fit(port_problem, port_cfg):
    est = DMTRLEstimator(config=port_cfg, device="cpu").fit(port_problem.train)
    sched = est.serving_scheduler(batch=4, slo_s=10.0, clock=VirtualClock())
    v1 = sched.version
    x = port_problem.test.x[2, 1].numpy()
    r1 = sched.submit(ScoreRequest(task=2, x=x))
    sched.step()
    est.partial_fit(port_problem.train)
    assert sched.version == v1 + 1
    r2 = sched.submit(ScoreRequest(task=2, x=x))
    sched.step()
    assert r1.snapshot_version == v1 and r2.snapshot_version == v1 + 1
    assert r2.score == pytest.approx(float(est.decision_function(x, tasks=2)[0]), abs=1e-6)
    m = sched.metrics.summary()
    assert m["completed"] == 2 and m["swaps"] == 1


def test_partial_fit_push_survives_manual_swap(port_problem, port_cfg):
    est = DMTRLEstimator(config=port_cfg, device="cpu").fit(port_problem.train)
    eng = est.scoring_engine(batch=3)
    eng.swap(np.zeros((eng.m, eng.d), np.float32))  # engine version ahead
    v_manual = eng.version
    est.partial_fit(port_problem.train)
    assert eng.version > v_manual
    x = port_problem.test.x[0, 0].numpy()
    z = eng.run([ScoreRequest(task=0, x=x)])[0].score
    assert z == pytest.approx(float(est.decision_function(x, tasks=0)[0]), abs=1e-6)


def test_dead_engines_are_dropped_from_the_push_list(port_problem, port_cfg):
    est = DMTRLEstimator(config=port_cfg, device="cpu").fit(port_problem.train)
    keep = est.scoring_engine(batch=2)
    est.scoring_engine(batch=2)  # dropped at once
    est.partial_fit(port_problem.train)
    assert len(est._model_refs) == 1 and keep.version == 2


# ---------------------------------------------------------------------------
# installed weights are copies (ROADMAP §C, C1): JAX arrays are immutable
# and jnp.asarray copies, so the JAX engine serves what was published
# whatever the caller does to its array afterwards
# ---------------------------------------------------------------------------
def _alias_probe():
    """W (3, 4) and one request x from RandomState(0), served for task 1."""
    rs = np.random.RandomState(0)
    return rs.randn(3, 4).astype(np.float32), rs.randn(4).astype(np.float32)


def test_engine_keeps_its_own_w_when_the_caller_zeroes_it():
    from repro.serve.mtl import MTLScoringEngine as JEngine

    W, x = _alias_probe()
    want = float(JEngine(W.copy()).score_batch(x[None], np.array([1]))[0])
    assert want == pytest.approx(1.6736, abs=1e-4)
    for W_in in (W.copy(), torch.from_numpy(W.copy())):
        eng = MTLScoringEngine(W_in, batch=2, device="cpu")
        W_in[:] = 0.0  # the caller reuses its buffer
        got = eng.score_batch(x[None], np.array([1]))[0]
        assert got == pytest.approx(want, abs=TOL) and eng.version == 0
        eng.swap(W_in)  # a swap installs the values of that moment ...
        W_in[:] = 1.0  # ... not what the caller writes later
        assert eng.score_batch(x[None], np.array([1]))[0] == pytest.approx(0.0, abs=TOL)


def test_scheduler_serves_the_published_w_not_a_later_write():
    W, x = _alias_probe()
    want = 1.6736
    eng = MTLScoringEngine(np.zeros_like(W), batch=2, device="cpu")
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock())
    Wt = torch.from_numpy(W.copy())
    assert sched.publish_weights(Wt) == 1
    Wt.mul_(2)  # after the publish, before the tile
    r = ScoreRequest(task=1, x=x)
    sched.submit(r)
    sched.step()
    assert r.snapshot_version == 1
    assert r.score == pytest.approx(want, abs=1e-4)
    assert r.score == pytest.approx(float(x @ W[1]), abs=TOL)
    # a dense Sigma rides the snapshot as a copy too
    sigma = torch.eye(3)
    sched.publish_weights(Wt, sigma)
    sigma.mul_(0)
    assert torch.equal(sched.snapshot.sigma, torch.eye(3))


def test_fleet_rolls_the_published_w_not_a_later_write():
    from repro_torch.serve import FleetRouter

    W, x = _alias_probe()
    replicas = [ContinuousBatchingScheduler(MTLScoringEngine(np.zeros_like(W), batch=2,
                                                             device="cpu"),
                                            clock=VirtualClock()) for _ in range(2)]
    router = FleetRouter(replicas)
    Wt = torch.from_numpy(W.copy())
    router.publish_weights(Wt)
    Wt.zero_()
    for _ in range(3):
        router.step()
    for rep in replicas:
        assert rep.snapshot.version == 1
        assert torch.equal(torch.as_tensor(rep.snapshot.W), torch.from_numpy(W))


# ---------------------------------------------------------------------------
# on the card: the captured graph
# ---------------------------------------------------------------------------
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_w(seed=0, m=10, d=784):
    return np.random.RandomState(seed).randn(m, d).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 256, 700])
def test_graph_replay_equals_eager_step(cuda, n):
    W = _card_w()
    eng = MTLScoringEngine(W, batch=256, device=cuda)
    eager = MTLScoringEngine(W, batch=256, device=cuda)
    rng = np.random.RandomState(n)
    X = rng.rand(n, W.shape[1]).astype(np.float32)
    t = rng.randint(0, W.shape[0], n)
    before = mtl_mod.ScoreGraph.captures
    eng.warmup()
    assert mtl_mod.ScoreGraph.captures == before + 1 and eng._graph is not None
    z_graph = eng.score_batch(X, t)
    # the eager step on the same rows
    Wt = torch.from_numpy(W).to(cuda)
    z_eager = mtl_mod.make_score_step()(Wt, torch.from_numpy(X).to(cuda),
                                         torch.from_numpy(t).to(cuda)).cpu().numpy()
    np.testing.assert_allclose(z_graph, z_eager, atol=TOL, rtol=0)
    np.testing.assert_allclose(z_graph, np.einsum("nd,nd->n", X, W[t]), atol=1e-4)
    assert eager._graph is None
    eager.score_batch(X[:1], t[:1])  # the first tile captures
    assert eager._graph is not None


@pytest.mark.gpu
def test_publish_between_replays_and_packed_w(cuda):
    W, W2 = _card_w(1), _card_w(2)
    eng = MTLScoringEngine(W, batch=64, version=1, device=cuda)
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock())
    eng.warmup()
    reqs = _requests(np.arange(40) % 10, d=784, seed=3)
    sched.submit_many(reqs)
    inner = eng.run_tile

    def swapping(tile, snapshot):
        sched.publish(ModelSnapshot(version=2, W=W2))  # lands mid-tile
        inner(tile, snapshot)

    eng.run_tile = swapping
    done = sched.step()
    eng.run_tile = inner
    assert len(done) == 40 and all(r.snapshot_version == 1 for r in done)
    for r in done:
        assert r.score == pytest.approx(float(r.x @ W[r.task]), abs=1e-4)
    more = _requests(np.arange(40) % 10, d=784, seed=4)
    sched.submit_many(more)
    sched.step()
    for r in more:  # the next replay sees the published W
        assert r.snapshot_version == 2
        assert r.score == pytest.approx(float(r.x @ W2[r.task]), abs=1e-4)
    # alternating snapshots through one graph: each tile gets its own W
    for snap_W in (W, W2, W):
        r = _requests([3], d=784, seed=5)
        eng.run_tile(r, ModelSnapshot(version=9, W=snap_W))
        assert r[0].score == pytest.approx(float(r[0].x @ snap_W[3]), abs=1e-4)


@pytest.mark.gpu
def test_in_place_update_republished_reaches_the_graph(cuda):
    """A tensor updated in place and re-published under a new version is
    served at its new values through the captured graph: every install is
    a fresh copy, so the graph's identity check sees a new W."""
    W = torch.from_numpy(_card_w(7)).to(cuda)
    eng = MTLScoringEngine(W, batch=64, version=1, device=cuda)
    eng.warmup()
    X = np.random.RandomState(8).rand(10, W.shape[1]).astype(np.float32)
    t = np.arange(10)
    Wn = W.cpu().numpy()
    np.testing.assert_allclose(eng.score_batch(X, t), np.einsum("nd,nd->n", X, Wn[t]),
                               atol=1e-4)
    for k in (2, 3):
        W.mul_(2.0)  # the producer updates its tensor in place
        assert eng.publish_weights(W, version=k) == k
        np.testing.assert_allclose(eng.score_batch(X, t),
                                   np.einsum("nd,nd->n", X, W.cpu().numpy()[t]), atol=1e-3)
    sched = ContinuousBatchingScheduler(eng, clock=VirtualClock())
    W.mul_(0.5)
    sched.publish_weights(W)
    W.zero_()  # after the publish: the tile still serves the published values
    reqs = _requests([0, 1, 2], d=W.shape[1], seed=9)
    sched.submit_many(reqs)
    sched.step()
    Wp = 0.5 * 4.0 * Wn
    for r in reqs:
        assert r.score == pytest.approx(float(r.x @ Wp[r.task]), abs=1e-3)


@pytest.mark.gpu
def test_adopted_graphs_share_one_capture(cuda):
    W = _card_w(3)
    engines = [MTLScoringEngine(W, batch=32, device=cuda) for _ in range(4)]
    before = mtl_mod.ScoreGraph.captures
    engines[0].warmup()
    assert all(e.adopt_warmup(engines[0]) for e in engines[1:])
    assert mtl_mod.ScoreGraph.captures == before + 1
    assert len({id(e._graph) for e in engines}) == 1
    assert not MTLScoringEngine(W, batch=16, device=cuda).adopt_warmup(engines[0])
    # replicas at different versions share the buffer and stay correct
    engines[1].swap(2.0 * W)
    X = np.random.RandomState(6).rand(5, W.shape[1]).astype(np.float32)
    t = np.array([0, 1, 2, 3, 4])
    for e in engines * 2:
        scale = 2.0 if e is engines[1] else 1.0
        np.testing.assert_allclose(e.score_batch(X, t),
                                   scale * np.einsum("nd,nd->n", X, W[t]), atol=1e-4)


def test_admit_accepts_and_refuses_as_the_batch_validator(W):
    """admit's check of a well-formed request and the one-row validation
    agree: the same requests pass, the same malformed ones raise."""
    eng = _engine(W, batch=2)
    ok = [ScoreRequest(task=t, x=x) for t, x in [
        (0, np.zeros(12, np.float32)), (np.int64(4), np.ones(12)),
        (2.0, np.zeros(12, np.float32)), (1, [0.5] * 12)]]
    for r in ok:
        eng.admit(r)
        eng._validate_batch(np.asarray(r.x, np.float32)[None], np.asarray([int(r.task)]))
    bad = [(5, np.zeros(12, np.float32), "task id"), (-1, np.zeros(12), "task id"),
           (0, np.zeros(11, np.float32), "feature shape"),
           (0, np.zeros((1, 12), np.float32), "feature shape"),
           (0, np.array(["a"] * 12), "could not convert")]
    for task, x, msg in bad:
        with pytest.raises(ValueError, match=msg):
            eng.admit(ScoreRequest(task=task, x=x))
