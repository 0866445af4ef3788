"""The port's mesh engines (repro_torch/core/distributed.py, the simulated
transport, engine="distributed") on the CPU.

The JAX package's own mesh engines fail on the installed jax (ROADMAP RC1),
so the port is held against JAX's single-process ``dmtrl.fit`` at the bars
of tests/test_distributed.py (one device: W 2e-4, Sigma 1e-5; several: W
5e-4, Sigma 5e-5; a pod axis: the gap shrinks below 0.8 of its first
value), against the golden integer histories exactly, and against its own
``fit_distributed`` for the simulated transport at tau = 0 (1e-6).

The one-device cases run here on the local mesh. The multi-rank cases run
in one 4-rank gloo world that a module fixture spawns once
(tests/torch_mesh_ranks.py: data = 4, data 2 x model 2 with and without
the hoisted block Gram and in bf16, data 2 x pod 2, low_rank_diag, padded
tasks, the simulated transport and the three 4-worker goldens); the JAX
references run in this process on the same data.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import DMTRLConfig as JConfig
from repro.core import fit as jfit
from repro.core.omega_regularizers import get_regularizer as jget_regularizer
from repro.data.synthetic import synthetic as jsynthetic
from repro_torch import prng
from repro_torch.core import (
    AsyncOptions,
    DistributedOptions,
    DMTRLConfig,
    DMTRLEstimator,
    MeshAxes,
    fit,
    fit_async,
    fit_distributed,
    get_engine,
    get_regularizer,
    local_mesh,
    make_mesh,
)
from repro_torch.core import distributed as dist_mod
from repro_torch.core import dual as dual_mod
from repro_torch.core.sigma_view import LowRankDiagSigma
from repro_torch.data.synthetic import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_W, TOL_SIGMA = 2e-4, 1e-5  # one device (tests/test_distributed.py:28-29)
TOL_W_MESH, TOL_SIGMA_MESH = 5e-4, 5e-5  # several devices (:77-78)
# gram_bf16 against the fp32 run: bf16 keeps 8 significant bits, so rounding
# X moves each entry by at most u = 2^-8 relative, a Gram entry or q (both
# factors rounded) by at most 2u = 2^-7 relative of the products' magnitude;
# to first order the deltas, alpha, W and Sigma = f(W W^T) move as much.
# Held at 2^-6 of the fp32 run's largest entry: a 2x margin on 2u.
TOL_BF16_REL = 2.0 ** -6


def _jkey(key: torch.Tensor):
    """A port key (its two 32-bit words) as a JAX raw uint32 key."""
    import jax.numpy as jnp

    return jnp.asarray((key.numpy().astype(np.int64) & 0xFFFFFFFF).astype(np.uint32))


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.fixture(scope="module")
def port_problem():
    return synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1)


@pytest.fixture(scope="module")
def port_cfg(small_cfg):
    return DMTRLConfig(**dataclasses.asdict(small_cfg))


@pytest.fixture(scope="module")
def jax_ref(small_problem, small_cfg):
    return jfit(small_cfg, small_problem.train)


@pytest.fixture(scope="module")
def cpu_mesh():
    return local_mesh(device="cpu")


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------
def test_local_mesh_and_identity_collectives(cpu_mesh):
    m = make_mesh((1,), ("data",), device="cpu")
    assert not m.distributed and m.shape == {"data": 1} and m.is_root
    assert m.coord("data") == 0 and m.group("data") is None
    t = torch.arange(6.0).view(2, 3)
    dist_mod.reset_collective_counts()
    assert dist_mod.all_gather(t, cpu_mesh, "data") is t
    assert dist_mod.psum(t, cpu_mesh, "data") is t
    assert dist_mod.broadcast(t, cpu_mesh) is t
    assert dist_mod.on_root(lambda: (t, 2.5, None), cpu_mesh)[1] == 2.5
    assert sum(dist_mod.COLLECTIVES.values()) == 0


def test_mesh_needs_a_process_group_beyond_one_position():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((4,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        make_mesh((1, 1), ("data",), device="cpu")


def test_collective_refuses_a_tensor_off_the_mesh_device():
    # a process-group mesh on the card handed a CPU tensor raises before
    # it reaches torch.distributed
    mesh = dist_mod.Mesh({"data": 2}, "cuda", groups={"data": object()}, device_mesh=object())
    with pytest.raises(ValueError, match="collective"):
        dist_mod.all_gather(torch.zeros(2, 3), mesh, "data")
    with pytest.raises(ValueError, match="collective"):
        dist_mod.psum(torch.zeros(2, 3), mesh, "data")


@pytest.mark.parametrize("coords", [(0, 0, 0), (1, 1, 1), (2, 0, 1)])
def test_shard_mtl_data_pads_and_keeps_the_block(coords):
    """m = 5 over data 3, n over pod 2, d = 15 over model 2: the JAX
    package's P(data, pod, model) blocks of the padded arrays."""
    sp = synthetic(1, m=5, d=15, n_train_avg=21, n_test_avg=5, seed=4).train
    names = ("data", "pod", "model")
    mesh = dist_mod.Mesh({"data": 3, "pod": 2, "model": 2}, "cpu", coords=dict(zip(names, coords)))
    local, m, d = dist_mod.shard_mtl_data(sp, mesh, MeshAxes(data="data", model="model", pod="pod"))
    n_pad = sp.n_max + sp.n_max % 2
    assert (m, d) == (6, 16)
    x = torch.zeros((6, n_pad, 16))
    x[:5, : sp.n_max, :15] = sp.x
    n = torch.cat([sp.n, torch.ones(1, dtype=sp.n.dtype)])
    di, pi, mi = coords
    rows, cols, feats = slice(2 * di, 2 * di + 2), slice(pi * n_pad // 2, (pi + 1) * n_pad // 2), \
        slice(8 * mi, 8 * mi + 8)
    assert torch.equal(local.x, x[rows, cols, feats])
    assert torch.equal(local.n, n[rows])
    assert tuple(local.y.shape) == (2, n_pad // 2) == tuple(local.mask.shape)


# ---------------------------------------------------------------------------
# one-device mesh against dmtrl.fit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("solver", ["block_gram", "pallas_round", "pallas_block"])
def test_one_device_mesh_matches_fit(port_problem, port_cfg, small_problem, small_cfg, jax_ref,
                                     cpu_mesh, solver):
    """The kernel backends run their plain versions on CPU tensors; JAX's
    reference is its block_gram fit (the same iterates; RC2)."""
    cfg = dataclasses.replace(port_cfg, solver=solver)
    W, sigma, state, hist = fit_distributed(cfg, port_problem.train, cpu_mesh)
    ew, es = _err(W, jax_ref.W), _err(sigma, jax_ref.sigma)
    own = fit(cfg, port_problem.train, device="cpu")
    ow, os_ = _err(W, own.W), _err(sigma, own.sigma)
    print(f"{solver}: |dW| {ew:.2e} |dSigma| {es:.2e} vs JAX fit; {ow:.2e} {os_:.2e} vs port fit")
    assert ew <= TOL_W and es <= TOL_SIGMA
    assert ow <= TOL_W and os_ <= TOL_SIGMA
    np.testing.assert_allclose(hist["gap"], own.history["gap"], atol=1e-5, rtol=1e-5)
    assert hist["w_staleness"].max() == 0 and hist["tau_trace"].max() == 0
    total = cfg.outer_iters * cfg.rounds
    np.testing.assert_array_equal(hist["tick"], np.arange(1, total + 1))


def test_padded_coordinates_stay_zero(cpu_mesh):
    """Per-task dual blocks move only where the task has samples (the
    port of the JAX test_stale_snapshots_never_mix_tasks), through the
    mesh engine and the simulated transport at tau 0 and 2."""
    sp = synthetic(1, m=4, d=12, n_train_avg=24, n_test_avg=6, seed=5).train
    mask = sp.mask.numpy()
    for tau in (None, 0, 2):
        cfg = DMTRLConfig(loss="squared", lam=1e-3, outer_iters=1, rounds=5, local_iters=32,
                          solver="block_gram", block_size=32, seed=7, tau=tau or 0)
        if tau is None:
            _, _, state, _ = fit_distributed(cfg, sp, cpu_mesh)
        else:
            _, _, state, _ = fit_async(cfg, sp, cpu_mesh)
        alpha = state.alpha[: sp.m].numpy()
        assert np.all(alpha[mask == 0.0] == 0.0)
        for i in range(sp.m):
            assert np.any(alpha[i][mask[i] == 1.0] != 0.0)


def test_warm_start_through_the_estimator(port_problem, port_cfg, cpu_mesh):
    """fit then partial_fit on the mesh engine: W stays W(alpha), and both
    steps equal the reference engine's."""
    est = DMTRLEstimator(engine="distributed", config=port_cfg, mesh=cpu_mesh, device="cpu")
    ref = DMTRLEstimator(engine="reference", config=port_cfg, device="cpu")
    for step in ("fit", "partial_fit"):
        getattr(est, step)(port_problem.train)
        getattr(ref, step)(port_problem.train)
        ew, es = _err(est.W_, ref.W_), _err(est.sigma_, ref.sigma_)
        print(f"{step}: |dW| {ew:.2e} |dSigma| {es:.2e}")
        assert ew <= TOL_W and es <= TOL_SIGMA
    W2 = dual_mod.weights_from_alpha(port_problem.train, est.alpha_, est.sigma_, port_cfg.lam)
    assert _err(est.W_, W2) <= 1e-4
    np.testing.assert_array_equal(est.history_["round"], np.arange(1, 13))


def test_custom_init_regularizer(port_problem, port_cfg, small_problem, small_cfg, cpu_mesh):
    """graph_laplacian installs its own Sigma at start (custom_init)."""
    A = np.ones((4, 4)) - np.eye(4)
    W, sigma, _, _ = fit_distributed(port_cfg, port_problem.train, cpu_mesh,
                                     regularizer=get_regularizer("graph_laplacian", adjacency=A))
    ref = jfit(small_cfg, small_problem.train,
               regularizer=jget_regularizer("graph_laplacian", adjacency=A))
    ew, es = _err(W, ref.W), _err(sigma, ref.sigma)
    print(f"graph_laplacian: |dW| {ew:.2e} |dSigma| {es:.2e}")
    assert ew <= TOL_W and es <= TOL_SIGMA


def test_low_rank_diag_below_full_rank(port_problem, port_cfg, small_problem, small_cfg,
                                       cpu_mesh):
    """low_rank_diag at r = 2 < m = 4 (ROADMAP D4: parity only below full
    rank) runs the factored reduce and keeps the factors."""
    W, sigma, state, hist = fit_distributed(
        port_cfg, port_problem.train, cpu_mesh,
        regularizer=get_regularizer("low_rank_diag", rank=2))
    assert isinstance(state.sigma, LowRankDiagSigma)
    ref = jfit(small_cfg, small_problem.train,
               regularizer=jget_regularizer("low_rank_diag", rank=2))
    ew, es = _err(W, ref.W), _err(sigma, ref.sigma)
    print(f"low_rank_diag r=2: |dW| {ew:.2e} |dSigma| {es:.2e}")
    assert ew <= TOL_W and es <= TOL_SIGMA
    assert hist["gap"][-1] < hist["gap"][0]


def test_factored_reduce_matches_dense(port_problem, port_cfg, cpu_mesh):
    """One round with a LowRankDiagSigma: the factored server reduce
    against the dense reduce of the same Sigma."""
    rs = np.random.RandomState(3)
    U = torch.from_numpy(rs.randn(4, 2).astype(np.float32)) * 0.3
    sv = LowRankDiagSigma(U=U, core=torch.diag(torch.tensor([0.5, 0.2])),
                          d=torch.full((4,), 0.05))
    data, m, d = dist_mod.shard_mtl_data(port_problem.train, cpu_mesh, MeshAxes())
    alpha = torch.zeros(tuple(data.y.shape))
    W = torch.from_numpy(0.1 * rs.randn(m, d).astype(np.float32))
    key = prng.PRNGKey(5)
    outs = []
    for structured, sigma in ((True, sv), (False, sv.dense())):
        rnd = dist_mod.make_distributed_round(port_cfg, cpu_mesh, MeshAxes(), m, data.n_max, d,
                                              1.0, structured=structured)
        outs.append(rnd(data.x, data.y, data.n, alpha, W, sigma, key))
    ea, ew = _err(outs[0][0], outs[1][0]), _err(outs[0][1], outs[1][1])
    print(f"factored vs dense: |dalpha| {ea:.2e} |dW| {ew:.2e}")
    assert ea == 0.0  # the same solve
    assert ew <= 1e-5


def test_golden_replay_one_device(port_cfg, cpu_mesh):
    """The simulated transport reproduces the 1-worker golden history
    exactly (the default transport, without a mesh: the local one)."""
    with open(os.path.join(REPO, "tests", "golden", "async_histories.json")) as f:
        rec = json.load(f)["g1_tau2_omega1"]
    kw = dict(rec["config"])
    kw["async_delays"] = tuple(kw["async_delays"])
    _, _, _, hist = fit_async(DMTRLConfig(**kw), synthetic(1, **rec["problem"]).train,
                              device="cpu")
    got = {k: np.asarray(hist[k]).astype(int).tolist() for k in rec["history"]}
    assert got == rec["history"]


def test_simulated_tau0_equals_fit_distributed(port_problem, port_cfg, cpu_mesh):
    W1, s1, st1, h1 = fit_distributed(port_cfg, port_problem.train, cpu_mesh)
    W2, s2, st2, h2 = fit_async(port_cfg, port_problem.train, cpu_mesh)
    e = max(_err(W1, W2), _err(s1, s2), _err(st1.alpha, st2.alpha))
    print(f"simulated tau=0 vs fit_distributed: max|d| {e:.2e}")
    assert e <= 1e-6
    for k in ("w_worker", "w_round", "w_staleness", "w_lag", "w_tick", "tau_trace", "tick"):
        np.testing.assert_array_equal(h1[k], h2[k])


# ---------------------------------------------------------------------------
# registry and facade (the JAX facade's checks and messages)
# ---------------------------------------------------------------------------
def test_registry_and_facade_checks(port_problem, port_cfg, cpu_mesh):
    assert get_engine("distributed").options_cls is DistributedOptions
    assert get_engine("async").options_cls is AsyncOptions
    with pytest.raises(ValueError, match="runs single-process"):
        get_engine("reference").run(port_cfg, port_problem.train, mesh=cpu_mesh, device="cpu")
    with pytest.raises(ValueError, match='mesh/axes need engine="distributed" or "async"'):
        DMTRLEstimator(engine="reference", mesh=cpu_mesh, device="cpu")
    with pytest.raises(ValueError, match="takes no DistributedOptions"):
        DMTRLEstimator(engine="reference", distributed=DistributedOptions(), device="cpu")
    with pytest.raises(ValueError, match='AsyncOptions need engine="async"'):
        DMTRLEstimator(engine="distributed", async_options=AsyncOptions(), device="cpu")
    with pytest.raises(TypeError, match="DistributedOptions"):
        DMTRLEstimator(engine="distributed", distributed={"gram_bf16": True}, device="cpu")
    with pytest.raises(ValueError, match="distributed=DistributedOptions"):
        DMTRLEstimator(engine="distributed", gram_bf16=True, device="cpu")
    est = DMTRLEstimator(engine="async", async_options=AsyncOptions(), device="cpu",
                         distributed=DistributedOptions(), config=port_cfg)
    est.fit(port_problem.train)
    assert est.engine.name == "async" and tuple(est.W_.shape) == (4, 16)


def test_axes_outside_the_mesh_raise(port_problem, port_cfg, cpu_mesh):
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        fit_distributed(port_cfg, port_problem.train, cpu_mesh, MeshAxes(data="workers"))


# ---------------------------------------------------------------------------
# n_i = 0: the plain rule (a padded task, a pod slice past its samples)
# ---------------------------------------------------------------------------
def test_empty_task_coordinates_follow_jax():
    """A task with no samples draws -1 in JAX's sample_coords, which its
    gathers wrap to the block's last row; the port wraps the index itself
    (coords_from_uniform), so every backend and kernel reads that row."""
    import jax.numpy as jnp

    from repro.core.sdca import sample_coords as jsample
    from repro_torch.core.sdca import gather_rows, sample_coords

    n_i = np.array([0, 5, 0, 37], np.int32)
    keys = prng.split(prng.PRNGKey(11), 4)
    got = sample_coords(keys, 64, torch.from_numpy(n_i), 37)
    x = np.random.RandomState(0).randn(4, 37, 3).astype(np.float32)
    for t in range(4):
        jc = jsample(_jkey(keys[t]), 64, jnp.int32(n_i[t]), 37)
        np.testing.assert_array_equal(got[t].numpy(), np.asarray(jc) % 37)
        rows = np.asarray(jnp.take_along_axis(jnp.asarray(x[t]), jc[:, None], axis=0))
        np.testing.assert_array_equal(gather_rows(torch.from_numpy(x), got)[t].numpy(), rows)
    assert (got[0] == 36).all() and (got[2] == 36).all()


@pytest.mark.parametrize("solver", ["block_gram", "pallas_round", "pallas_block"])
def test_empty_task_solve_matches_jax(solver):
    """A round over tasks with n_i = 0 and 0 < n_i < n_max: the port's
    backends (the kernels' plain versions here) against JAX's block_gram
    solver on the same keys, at the solver bar 2e-5."""
    import jax
    import jax.numpy as jnp

    from repro.core.losses import get_loss as jget_loss
    from repro.core.solver_backends import get_backend as jget_backend
    from repro_torch.core.losses import get_loss
    from repro_torch.core.solver_backends import get_backend

    sp = synthetic(1, m=4, d=16, n_train_avg=40, n_test_avg=10, seed=1).train
    n = torch.tensor([0, 7, 0, int(sp.n[3])], dtype=torch.int32)
    rs = np.random.RandomState(2)
    alpha = torch.from_numpy((0.3 * rs.rand(sp.m, sp.n_max)).astype(np.float32)) * sp.mask
    W = torch.from_numpy((0.1 * rs.randn(sp.m, sp.d)).astype(np.float32))
    sig = torch.full((sp.m,), 0.25)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(3), torch.arange(sp.m)), 0)
    solve = get_backend(solver).make_from_uniform(get_loss("hinge"), 1.0, 1e-3, 64, block=32)
    da, r = solve(sp.x, sp.y, alpha, W, n, sig, prng.uniform(keys, (64,)))
    jsolve = jget_backend("block_gram").make(jget_loss("hinge"), 1.0, 1e-3, 64, block=32)
    jda, jr = jax.vmap(jsolve)(jnp.asarray(sp.x.numpy()), jnp.asarray(sp.y.numpy()),
                               jnp.asarray(alpha.numpy()), jnp.asarray(W.numpy()),
                               jnp.asarray(n.numpy()), jnp.asarray(sig.numpy()),
                               _jkey(keys))
    e = max(_err(da, jda), _err(r, jr))
    print(f"{solver} with empty tasks: max|d(dalpha, r)| {e:.2e}")
    assert e <= 2e-5


# ---------------------------------------------------------------------------
# multi-rank: one 4-rank gloo world for every scenario
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ranks")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])}
    proc = subprocess.run(
        [sys.executable, "-c", f"import torch_mesh_ranks as r; r.main({str(out)!r})"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = []
    for r in range(4):
        with open(out / f"rank{r}.json") as f:
            res.append(json.load(f))
    return res


def _jax_mesh_fit(loss, m=8, **kw):
    sp = jsynthetic(1, m=m, d=32, n_train_avg=70, n_test_avg=20, seed=2)
    cfg = JConfig(loss=loss, lam=1e-3, outer_iters=2, rounds=3, local_iters=64,
                  solver="block_gram", block_size=32, seed=0)
    return jfit(cfg, sp.train, **kw)


def test_ranks_return_the_same_results(ranks):
    """Every rank returns the same W, Sigma and history (gathered at the
    end, the Omega-step and objectives broadcast from the root)."""
    assert sorted(r["data4"]["coords"][0] for r in ranks) == [0, 1, 2, 3]
    for name in ranks[0]:
        for r in ranks[1:]:
            for k in ("W", "sigma", "gap"):
                if isinstance(ranks[0][name], dict) and k in ranks[0][name]:
                    assert r[name][k] == ranks[0][name][k], (name, k)


def test_data_axis_matches_fit(ranks):
    ref = _jax_mesh_fit("hinge")
    out = ranks[0]["data4"]
    ew, es = _err(out["W"], ref.W), _err(out["sigma"], ref.sigma)
    print(f"data=4 hinge: |dW| {ew:.2e} |dSigma| {es:.2e}")
    assert ew <= TOL_W_MESH and es <= TOL_SIGMA_MESH


@pytest.mark.parametrize("name", ["model", "model_hoisted"])
def test_model_axis_matches_fit(ranks, name):
    """data 2 x model 2, squared loss: the Gram form summed over model."""
    ref = _jax_mesh_fit("squared")
    out = ranks[0][name]
    ew, es = _err(out["W"], ref.W), _err(out["sigma"], ref.sigma)
    print(f"{name}: |dW| {ew:.2e} |dSigma| {es:.2e}")
    assert ew <= TOL_W_MESH and es <= TOL_SIGMA_MESH


def test_gram_bf16_against_fp32(ranks):
    fp32, bf16 = ranks[0]["model"], ranks[0]["model_bf16"]
    ew = _err(bf16["W"], fp32["W"]) / np.max(np.abs(fp32["W"]))
    es = _err(bf16["sigma"], fp32["sigma"]) / np.max(np.abs(fp32["sigma"]))
    print(f"gram_bf16 vs fp32, relative to the largest entry: W {ew:.2e}, Sigma {es:.2e} "
          f"(bar {TOL_BF16_REL:.2e})")
    assert 0.0 < ew <= TOL_BF16_REL and es <= TOL_BF16_REL


def test_pod_axis_converges(ranks):
    gap = ranks[0]["pod"]["gap"]
    print(f"data 2 x pod 2: gap {gap[0]:.4f} -> {gap[-1]:.4f}")
    assert gap[-1] < 0.8 * gap[0]


def test_low_rank_diag_over_data_axis(ranks):
    ref = _jax_mesh_fit("hinge", regularizer=jget_regularizer("low_rank_diag", rank=4))
    out = ranks[0]["low_rank"]
    assert out["U_rows"] == [2, 4]  # each rank holds its U rows
    ew, es = _err(out["W"], ref.W), _err(out["sigma"], ref.sigma)
    print(f"low_rank_diag r=4 over data=4: |dW| {ew:.2e} |dSigma| {es:.2e}")
    assert ew <= TOL_W_MESH and es <= TOL_SIGMA_MESH


def test_padded_tasks_match_the_threaded_server(ranks):
    """6 tasks over 4 workers pad to 8, as the threaded server with 4
    workers does (the same init, Omega-step embedding and rho): the two
    agree at tau = 0, and the padded tasks stay inert."""
    sp = synthetic(1, m=6, d=32, n_train_avg=70, n_test_avg=20, seed=2).train
    cfg = DMTRLConfig(loss="hinge", lam=1e-3, outer_iters=2, rounds=3, local_iters=64,
                      solver="block_gram", block_size=32, seed=0)
    W, sigma, _, _ = fit_async(cfg, sp, options=AsyncOptions(transport="threaded", n_workers=4),
                               device="cpu")
    out = ranks[0]["padded"]
    ew, es = _err(out["W"], W), _err(out["sigma"], sigma)
    print(f"padded tasks vs threaded: |dW| {ew:.2e} |dSigma| {es:.2e}")
    assert ew <= TOL_W_MESH and es <= TOL_SIGMA_MESH
    alpha = np.concatenate([np.asarray(r["padded"]["alpha"]) for r in ranks])
    assert alpha.shape[0] == 8 and np.all(alpha[6:] == 0.0)
    assert np.all(alpha[:6][sp.mask.numpy() == 0.0] == 0.0)


@pytest.mark.parametrize(
    "case", ["g4_straggler_tau1", "g4_straggler_tau4_omega2", "g4_straggler_tau_auto"])
def test_golden_replay_four_workers(ranks, case):
    with open(os.path.join(REPO, "tests", "golden", "async_histories.json")) as f:
        rec = json.load(f)[case]
    for r in ranks:
        assert r[case] == rec["history"]


def test_simulated_tau0_over_four_workers(ranks):
    sim, sync = ranks[0]["simulated_tau0"], ranks[0]["data4"]
    e = max(_err(sim["W"], sync["W"]), _err(sim["sigma"], sync["sigma"]))
    print(f"simulated tau=0 vs fit_distributed, data=4: max|d| {e:.2e}")
    assert e <= 1e-6
    ints = sim["ints"]
    assert max(ints["w_staleness"]) == 0 and max(ints["w_lag"]) == 0
    assert sorted(set(ints["w_worker"])) == [0, 1, 2, 3]
