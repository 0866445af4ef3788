"""The port's gossip transport (repro_torch/core/gossip.py) against the JAX
package's, mirroring tests/test_gossip.py:

  * ``build_adjacency``, ``mixing_matrix`` and ``spectral_gap`` equal to
    repro.core.gossip's (numpy in both: adjacency exact, weights and gap to
    1e-12), including explicit adjacencies and the validation errors;
  * on a complete graph the gossip fit matches the port's threaded server
    (W and Sigma to the float-association tolerance 5e-5 of the JAX test,
    final objective within 1e-5) and the JAX ``dmtrl.fit`` at the fit
    bars; on a ring the gap shrinks and stays near the server's;
  * codec sweep bounds, per-edge staleness accounting, wire stats.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import dmtrl as jdmtrl
from repro.core import gossip as jgossip
from repro_torch import prng
from repro_torch.core import AsyncOptions, DMTRLConfig, fit_async
from repro_torch.core import convergence as cv
from repro_torch.core import omega_regularizers as treg
from repro_torch.core.dmtrl import _rho_value
from repro_torch.core.gossip import build_adjacency, mixing_matrix, spectral_gap
from repro_torch.core.transport import get_transport
from repro_torch.data.synthetic import synthetic

ATOL = 5e-5  # float-association tolerance (tests/test_gossip.py)
TOL_W, TOL_SIGMA = 2e-4, 1e-5  # the fit bars


@pytest.fixture(scope="module")
def port_problem():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)


@pytest.fixture(scope="module")
def port_cfg(small_cfg):
    return DMTRLConfig(**dataclasses.asdict(small_cfg))


def _fit(cfg, data, transport, n_workers, **kw):
    opts = AsyncOptions(transport=transport, n_workers=n_workers, **kw)
    return fit_async(cfg, data, options=opts, device="cpu")


def _random_connected(G, rng):
    adj = np.zeros((G, G), np.int64)
    order = rng.permutation(G)
    for i in range(1, G):
        j = order[rng.integers(0, i)]
        adj[order[i], j] = adj[j, order[i]] = 1
    for _ in range(int(rng.integers(0, G))):
        a, b = rng.integers(0, G, size=2)
        if a != b:
            adj[a, b] = adj[b, a] = 1
    return adj


# ---------------------------------------------------------------------------
# topology -> adjacency -> mixing matrix, against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology", ["ring", "torus", "complete"])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 8, 16])
def test_topologies_equal_jax(topology, G):
    adj = build_adjacency(topology, G)
    assert np.array_equal(adj, jgossip.build_adjacency(topology, G))
    M = mixing_matrix(adj)
    np.testing.assert_allclose(M, jgossip.mixing_matrix(adj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(M.sum(axis=0), 1.0, atol=1e-12)
    np.testing.assert_allclose(M, M.T, atol=1e-12)
    assert spectral_gap(M) == pytest.approx(jgossip.spectral_gap(M), abs=1e-12)


@pytest.mark.parametrize("seed", range(6))
def test_random_explicit_topologies_equal_jax(seed):
    rng = np.random.default_rng(seed)
    G = int(rng.integers(2, 9))
    adj = _random_connected(G, rng)
    a = build_adjacency(adj, G)
    assert np.array_equal(a, jgossip.build_adjacency(adj, G))
    M = mixing_matrix(a)
    np.testing.assert_allclose(M, jgossip.mixing_matrix(a), atol=1e-12)
    assert 0.0 < spectral_gap(M) == pytest.approx(jgossip.spectral_gap(M), abs=1e-12)


def test_spectral_gap_ordering():
    gaps = {t: spectral_gap(mixing_matrix(build_adjacency(t, 8)))
            for t in ("ring", "torus", "complete")}
    assert gaps["complete"] == pytest.approx(1.0)
    assert gaps["ring"] < gaps["torus"] < gaps["complete"]


def test_explicit_adjacency_validation():
    bad = np.zeros((3, 3), np.int64)
    bad[0, 1] = 1
    cases = [
        (bad, 3, "symmetric"),
        (np.full((2, 2), 2.0) - 2 * np.eye(2), 2, "0/1"),
        (np.eye(3, dtype=np.int64), 3, "zero diagonal"),
        (np.zeros((3, 3), np.int64), 4, r"\(4, 4\)"),
        (np.zeros((3, 3), np.int64), 3, "disconnected"),
        ("hypercube", 4, "unknown gossip topology"),
    ]
    for topo, G, match in cases:
        for fn in (build_adjacency, jgossip.build_adjacency):
            with pytest.raises(ValueError, match=match):
                fn(topo, G)


def test_topology_options_validated(port_problem, port_cfg):
    with pytest.raises(ValueError, match="topology"):
        AsyncOptions(topology="hypercube")
    with pytest.raises(ValueError, match="topology"):
        AsyncOptions(topology=7)
    AsyncOptions(transport="gossip", topology="ring", codec="int8")
    with pytest.raises(ValueError, match="gossip"):
        _fit(port_cfg, port_problem.train, "threaded", 2, topology="ring")
    with pytest.raises(ValueError, match="disconnected"):
        two = ((0, 1, 0, 0), (1, 0, 0, 0), (0, 0, 0, 1), (0, 0, 1, 0))
        _fit(port_cfg, port_problem.train, "gossip", 4, topology=two)


# ---------------------------------------------------------------------------
# fits
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def threaded_result(port_problem, port_cfg):
    return _fit(port_cfg, port_problem.train, "threaded", 4)


def test_complete_graph_matches_threaded_and_jax(
    small_problem, small_cfg, port_problem, port_cfg, threaded_result
):
    Wt, st, _, ht = threaded_result
    Wg, sg, _, hg = _fit(port_cfg, port_problem.train, "gossip", 4, topology="complete")
    np.testing.assert_allclose(Wg.numpy(), Wt.numpy(), atol=ATOL)
    np.testing.assert_allclose(sg.numpy(), st.numpy(), atol=ATOL)
    assert abs(float(hg["primal"][-1]) - float(ht["primal"][-1])) <= 1e-5
    ref = jdmtrl.fit(small_cfg, small_problem.train)
    np.testing.assert_allclose(Wg.numpy(), np.asarray(ref.W), atol=TOL_W)
    np.testing.assert_allclose(sg.numpy(), np.asarray(ref.sigma), atol=TOL_SIGMA)


def test_ring_gap_shrinks_near_server(port_problem, port_cfg, threaded_result):
    _, _, _, ht = threaded_result
    Wg, _, _, hg = _fit(port_cfg, port_problem.train, "gossip", 4, topology="ring")
    assert np.all(np.isfinite(Wg.numpy()))
    assert hg["gap"][-1] < hg["gap"][0]
    obj_g, obj_t = float(hg["primal"][-1]), float(ht["primal"][-1])
    assert abs(obj_g - obj_t) <= 0.2 * abs(obj_t)


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_codec_sweep_objective_gap(port_problem, port_cfg, threaded_result, codec):
    _, _, _, ht = threaded_result
    _, _, _, hg = _fit(port_cfg, port_problem.train, "gossip", 4, codec=codec)
    gap = abs(float(hg["primal"][-1]) - float(ht["primal"][-1]))
    bound = {"bf16": 5e-3, "int8": 2e-2}[codec]
    assert gap <= bound * max(1.0, abs(float(ht["primal"][-1])))


def test_per_edge_staleness_history_and_summary(port_problem, port_cfg, threaded_result):
    _, _, _, hist = _fit(port_cfg, port_problem.train, "gossip", 4, tau=1, topology="ring")
    for k in ("e_src", "e_dst", "e_stal", "e_tick"):
        assert k in hist and len(hist[k])
    assert len(hist["e_stal"]) % 4 == 0  # 4 ring edges per exchange
    summ = cv.staleness_summary(hist)
    assert summ["n_exchanges"] == len(hist["e_stal"])
    assert summ["max_edge_staleness"] >= summ["mean_edge_staleness"] >= 0.0
    assert set(summ["per_edge_mean"]) == {(0, 1), (0, 3), (1, 2), (2, 3)}
    assert "n_exchanges" not in cv.staleness_summary(threaded_result[3])


def test_gossip_wire_stats_monotone_under_codecs(port_problem, port_cfg):
    totals = {}
    for codec in ("none", "bf16", "int8"):
        cfg = AsyncOptions(transport="gossip", n_workers=4, codec=codec).merge_into(port_cfg)
        reg = treg.resolve_regularizer(cfg, None, m=port_problem.train.m)
        t = get_transport("gossip").factory()
        t.setup(cfg, port_problem.train, mesh=None, axes=None, reg=reg, init=None,
                track=False, device="cpu")
        try:
            key = prng.PRNGKey(0)
            rho_sigma = t.rho_sigma()
            for p in range(cfg.outer_iters):
                key, ok = prng.split(key)
                t.run_w_step(p, _rho_value(cfg, rho_sigma, reg=reg), ok)
                sig, om = t.pad_sigma(*reg.step(t.w_true(), cfg.omega_jitter))
                t.install_sigma(sig, om, defer=False)
                rho_sigma = sig
            s = t.wire_stats
            assert s["n_exchanges"] > 0 and s["spectral_gap"] == pytest.approx(1.0)
            totals[codec] = s["snapshot_bytes"] + s["commit_bytes"] + s["mix_bytes"]
        finally:
            t.close()
    assert totals["none"] > totals["bf16"] > totals["int8"]
