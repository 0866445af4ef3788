"""The benchmark's harness on the CPU: its files found by name, its
formulas and readers, its refusal without a card, its imports, and a run
whose timed path is broken coming out not correct.

    python -m pytest perfbench/tests
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import spec  # noqa: E402

fit_flops = spec.metric_module("fit_mfu").fit_flops
sdca_least_seconds = spec.metric_module("sdca_roofline").least_seconds

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]
TINY_CONFIG = {"generator": "synthetic1", "lam": 1e-3,
               "params": {"m": 12, "d": 8, "n_train_avg": 70, "n_test_avg": 10}}


def tiny_cell(traffic_name: str = "paper_omega", limits=None, **traffic_over) -> spec.Cell:
    """A cell of the benchmark's traffic at a size the CPU runs in seconds."""
    traffic = spec.load_json(spec.HERE / "traffic" / f"{traffic_name}.json")
    traffic.update(outer_iters=2, rounds=3, track_every=2, **traffic_over)
    lim = limits or {"alpha": 1e-3, "W": 1e-3, "obj": 1e-3, "sigma": 1e-3, "rho": 1e-3,
                     "scores": 1e-3}
    return spec.Cell("tiny", 1, TINY_CONFIG, traffic, lim, BENCH["end_to_end"],
                     BENCH["per_layer"])


# -- files found by name ---------------------------------------------------
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    c = spec.cell(name)
    w = [w for w in BENCH["workloads"] if w["name"] == name][0]
    assert c.config["name"] == w["config"] and c.traffic["name"] == w["traffic"]
    assert c.chips == w["chips"]
    assert {m["name"] for m in c.end_to_end} >= {"fit_s", "peak_gb", "setup_s"}
    assert c.per_layer and set(c.limits) <= {"alpha", "W", "obj", "sigma", "rho", "scores"}


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert spec.reader(name)({}) is None  # nothing to read: nothing returned


def test_config_files_match_benchmark():
    for c in BENCH["configs"]:
        conf = spec.load_json(ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


def test_a_new_cell_needs_no_edit(tmp_path):
    """A dataset, a configuration, a traffic mix, a cell and a metric added
    as files and entries are found with no file of the harness changed."""
    here = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "data" / "new_gen.py").write_text(
        "import numpy as np\n"
        "from perfbench.data.arrays import TaskArrays\n\n"
        "def generate(seed, m, d, n):\n"
        "    rng = np.random.RandomState(seed)\n"
        "    x = [rng.rand(n, d).astype(np.float32) for _ in range(m)]\n"
        "    y = [np.sign(rng.rand(n) - 0.5).astype(np.float32) for _ in range(m)]\n"
        "    return TaskArrays(x, y, x, y)\n")
    conf = {"name": "new_conf", "generator": "new_gen", "lam": 1e-3,
            "params": {"m": 3, "d": 4, "n": 5}}
    (here / "configs" / "new_conf.json").write_text(json.dumps(conf))
    traffic = spec.load_json(here / "traffic" / "paper_omega.json")
    (here / "traffic" / "new_mix.json").write_text(json.dumps(dict(traffic, name="new_mix")))
    (here / "limits" / "new_conf.new_mix.json").write_text(json.dumps({"W": 1e-3}))
    (here / "metrics" / "fits.per_s.py").write_text(
        "def read(record):\n    return 1.0 / record['fit_s'] if record.get('fit_s') else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "new_conf", "source": "s", "file": "x", "reduced": [],
                             "why": "w"})
    bench["workloads"].append({"name": "new_conf.new_mix", "config": "new_conf",
                               "traffic": "new_mix", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "fits.per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "fit_s"})
    c = spec.cell("new_conf.new_mix", bench, here)
    assert c.traffic["name"] == "new_mix" and c.limits == {"W": 1e-3}
    arrays = spec.make_data(c.config, 7, here)
    assert len(arrays.xtr) == 3 and arrays.xtr[0].shape == (5, 4)
    assert [m["name"] for m in c.per_layer][-1] == "fits.per_s"
    assert spec.reader("fits.per_s", here)({"fit_s": 0.5}) == 2.0


# -- formulas and readers --------------------------------------------------
def test_sdca_least_time_by_hand():
    # m = 2, H = 3, d = 5: 4 * 30 = 120 FLOPs; 6 * (20 + 12) + 8 * 10 = 272 bytes
    from perfbench import peaks

    assert sdca_least_seconds(2, 3, 5) == max(120 / peaks.FP32_FLOPS, 272 / peaks.HBM_BYTES_PER_S)
    # at MNIST's shapes the bytes bound it: 10 x 12032 rows of 784 floats
    t = sdca_least_seconds(10, 12032, 784)
    assert t == pytest.approx((10 * 12032 * (4 * 784 + 12) + 8 * 10 * 784) / 3.35e12)


def test_fit_flops_by_hand():
    sh = dict(m=2, d=3, n_total=10, H=4, outer_iters=1, rounds=2, tracked=2,
              member="trace_constraint", rank=0, iters=8)
    sdca, reduce_ = 4 * 2 * 4 * 3, 2 * 4 * 3
    per_eval = 4 * 10 * 3 + reduce_ + 2 * 2 * 3
    w_alpha = 2 * 10 * 3 + reduce_
    omega = 2 * 4 * 3 + 9 * 8 + 2 * 8
    rho = 2 * 4
    assert fit_flops(sh) == 2 * (sdca + reduce_) + w_alpha + omega + rho + 2 * per_eval
    # no count for another Omega-step: the reader returns nothing
    other = dict(CANNED, shapes=dict(CANNED["shapes"], member="low_rank_diag"))
    assert spec.reader("fit_mfu")(other) is None


CANNED = dict(
    shapes=dict(m=10, d=784, n_total=120000, H=12032, B=64, n_max=12000, outer_iters=4,
                rounds=10, tracked=8, member="trace_constraint", rank=0, iters=8),
    fit_s=0.25,
    device=dict(busy_s=0.09, window_s=0.3),
    kernels=[("void sdca::round_stage1<64>(float*)", 0.0, 440.0),
             ("void sdca::round_stage2<64>(float*)", 500.0, 1540.0),
             ("ampere_sgemm_32x32", 1600.0, 1700.0)],
    spans=dict(round=dict(calls=4, seconds=0.012), omega_step=dict(calls=2, seconds=0.004)),
    counters=dict(fits_profiled=1, rounds_profiled=1),
)


def test_readers_on_a_canned_record():
    def read(name):
        return spec.reader(name)(CANNED)

    assert read("round_ms") == pytest.approx(3.0)
    assert read("omega_ms") == pytest.approx(2.0)
    assert read("device_idle") == pytest.approx(70.0)
    assert read("sdca_roofline") == pytest.approx(
        100 * sdca_least_seconds(10, 12032, 784) / 1480e-6)
    assert read("fit_mfu") == pytest.approx(100 * fit_flops(CANNED["shapes"]) / (0.25 * 67e12))
    no_k1 = dict(CANNED, kernels=[("ampere_sgemm_32x32", 0.0, 10.0)])
    assert spec.reader("sdca_roofline")(no_k1) is None


def test_trace_union_and_gaps():
    from perfbench import trace

    dev = [("a", 0.0, 10.0), ("b", 5.0, 20.0), ("c", 30.0, 40.0)]
    assert trace.busy_seconds(dev) == pytest.approx(30e-6)
    assert trace.gaps(dev) == [(20.0, 30.0)]
    out = trace.breakdown(dict(device=dev, host=[("outer", 0.0, 50.0), ("inner", 19.0, 31.0)]))
    assert out["idle_gaps"] == [["inner", pytest.approx(10e-6)]]
    assert out["device_ops"][0] == ["b", pytest.approx(15e-6)]


# -- refusal without a card and without the program ------------------------
def _run_py(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env,
    )


def test_run_fails_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run_py(tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""


# -- imports ---------------------------------------------------------------
def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted(p.relative_to(spec.HERE).as_posix()
                                        for p in spec.HERE.rglob("*.py")))
def test_no_jax_and_a_plain_reference(path):
    top = _imports(spec.HERE / path)
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top
    if path.startswith("reference/"):
        assert "repro_torch" not in top and "perfbench" not in top, top


def test_forbidden_modules_by_whole_name(monkeypatch):
    from perfbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]


# -- a whole run on the CPU, sound and with the timed path broken ---------
def _run_tiny(cell, seed=2**31 + 5):
    from perfbench import run

    return run.run(cell, seed, 0.2, False, device="cpu", log=open(os.devnull, "w"))


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_sound_run_is_correct(seed):
    res = _run_tiny(tiny_cell(), seed)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1
    assert set(res["metrics"]) == {"fit_s", "peak_gb", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_the_tasks", "answer_altered"])
def test_broken_timed_path_is_not_correct(fault):
    from perfbench.faults import planted

    with planted(fault):
        res = _run_tiny(tiny_cell())
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("change", [
    {"loss": "squared"}, {"engine": "distributed"}, {"local_iters": 32},
    {"omega": {"member": "low_rank_diag", "params": {"rank": 4}}},
    {"omega": {"member": "trace_constraint", "params": {"eps": 1e-3}}},
    {"staleness": 1},
])
def test_reference_refuses_what_it_does_not_implement(change):
    from perfbench.reference import algorithm1

    traffic = dict(spec.load_json(spec.HERE / "traffic" / "paper_omega.json"), **change)
    with pytest.raises(ValueError):
        algorithm1.job_from(traffic, TINY_CONFIG)
    with pytest.raises(ValueError):
        _run_tiny(spec.Cell("tiny", 1, TINY_CONFIG, traffic, {"W": 1e-3}, [], []))


# -- the reference against the port's CPU path, layer by layer -------------
def test_reference_round_objective_and_omega_step_agree_with_the_port():
    import torch
    from repro_torch.core import dual, omega
    from repro_torch.core.dmtrl import DMTRLConfig, make_w_step_round
    from repro_torch.core.losses import get_loss
    from repro_torch.core.mtl_data import from_task_list
    from repro_torch import prng

    from perfbench.reference import algorithm1 as a1
    from perfbench.reference import threefry

    arr = spec.make_data(TINY_CONFIG, 11)
    data = from_task_list(arr.xtr, arr.ytr)
    ar = a1._Arith("float64")
    pb = a1.Problem(arr.xtr, arr.ytr, arr.xte, arr.yte, "cpu", ar)
    m, d = data.m, data.d
    rs = np.random.RandomState(0)
    W0 = 0.1 * rs.randn(m, d)
    A = rs.randn(m, m)
    S = A @ A.T / m + np.eye(m)
    S /= np.trace(S)
    # one round: local SDCA of every task and the reduce
    cfg = DMTRLConfig(lam=1e-3, solver="block_gram", local_iters=0, block_size=64)
    key = prng.PRNGKey(5)
    alpha0 = torch.zeros(data.y.shape)
    a_p, W_p = make_w_step_round(cfg, data, 1.5)(
        alpha0, torch.tensor(W0, dtype=torch.float32), torch.tensor(S, dtype=torch.float32), key)
    H = int(np.ceil(data.n_max / 64)) * 64
    coords = a1._coords(threefry.key(5), m, H, pb.n_np)
    sig = torch.tensor(S)
    kappa = 1.5 * np.diag(S) / (1e-3 * pb.n_np)
    alpha_r = torch.zeros((m, pb.n_max), dtype=torch.float64)
    dal, r = a1._local_round(pb, alpha_r, torch.tensor(W0), coords, kappa, 64, ar)
    dal = dal.numpy()
    W_r = torch.tensor(W0) + ar.mm(sig, r / pb.n[:, None]) / 1e-3
    assert np.abs(a_p.numpy() - dal).max() < 1e-4
    # the reduce divides float32 sums by lambda = 1e-3
    assert np.abs(W_p.numpy() - W_r.numpy()).max() < 1e-3 * np.abs(W_r.numpy()).max()
    # the objectives at that alpha
    alpha = torch.tensor(dal)
    hinge = get_loss("hinge")
    dd = float(dual.dual_objective(data, a_p, torch.tensor(S, dtype=torch.float32), 1e-3, hinge))
    pp = float(dual.primal_objective_from_alpha(
        data, a_p, torch.tensor(S, dtype=torch.float32), 1e-3, hinge))
    dr, pr = a1._objectives(pb, alpha, sig, 1e-3, ar)
    assert abs(dd - dr) < 1e-4 * abs(pr) and abs(pp - pr) < 1e-4 * abs(pr)
    # the Omega-step on one W of full row rank (W W^T with zero
    # eigenvalues would put float32 rounding under a square root)
    W_f = torch.tensor(rs.randn(6, d), dtype=torch.float32)
    W_r = W_f.double()
    s_p, _ = omega.omega_step(W_f)
    s_r = a1._omega_trace(W_r, ar, 1e-6).numpy()
    assert np.abs(s_p.numpy() - s_r).max() < 1e-4 * np.abs(s_r).max()
