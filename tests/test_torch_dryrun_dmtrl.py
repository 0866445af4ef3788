"""The port's DMTRL dry run (repro_torch.launch.dryrun_dmtrl).

  * The meta trace of one make_distributed_round at one position equals the
    cost counter over the same round on CPU tensors, exactly, for every
    solver backend and for a loss the kernels take and one they do not.
  * The trace at rank 0 of a fake 4-rank world equals rank 0 of a real
    4-rank gloo world running the round (tests/torch_dryrun_ranks.py, one
    world for the module): FLOPs, bytes, kernels, collective calls and
    bytes by kind.
  * model_flops is the JAX dry run's expression; run() writes its row.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import DMTRLConfig, MeshAxes, make_mesh
from repro_torch.launch import dryrun_dmtrl, fake_world, make_host_mesh

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import torch_dryrun_ranks as ranks_mod  # noqa: E402

M, N_MAX, D, H, BLOCK = 6, 40, 10, 32, 16


@pytest.mark.parametrize("loss", ["hinge", "logistic"])
@pytest.mark.parametrize("solver", ["naive", "block_gram", "pallas_block", "pallas_round"])
def test_meta_trace_equals_cpu_round(solver, loss):
    cfg = DMTRLConfig(loss=loss, lam=1e-3, local_iters=H, solver=solver, block_size=BLOCK)
    meta, cpu = (_one_position(cfg, MeshAxes(data="data"), dev) for dev in ("meta", "cpu"))
    assert meta == cpu
    kernel = {"pallas_block": "K2", "pallas_round": "K1"}.get(solver) if loss == "hinge" else None
    assert meta["kernels"] == ({kernel: H // BLOCK if kernel == "K2" else 1} if kernel else {})


def _one_position(cfg, axes, device):
    return dryrun_dmtrl.trace_round(cfg, make_host_mesh(1, 1, device=device), axes, M, N_MAX,
                                    D, 2.0).counted()


@pytest.mark.parametrize("hoisted", [False, True])
def test_meta_trace_equals_cpu_round_gram_form(hoisted):
    """With a model axis the round takes the Gram form in torch (the full
    H x H Gram, or the block Gram per H-block when hoisted)."""
    cfg = DMTRLConfig(local_iters=H, block_size=BLOCK, dist_block_hoisted=hoisted)
    axes = MeshAxes(data="data", model="model")
    meta, cpu = (_one_position(cfg, axes, dev) for dev in ("meta", "cpu"))
    assert meta == cpu and meta["flops"] > 0 and not meta["collectives"]


def test_kernel_counts_follow_their_formulas():
    from repro_torch.kernels.sdca.ops import k1_cost, k2_cost

    axes = MeshAxes(data="data")
    mesh = make_host_mesh(1, 1, device="meta")
    for solver, name, cost in (("pallas_round", "K1", k1_cost(M, N_MAX, D, H, BLOCK, 4)),
                               ("pallas_block", "K2", k2_cost(M, BLOCK, D, 4))):
        cfg = DMTRLConfig(local_iters=H, solver=solver, block_size=BLOCK)
        c = dryrun_dmtrl.trace_round(cfg, mesh, axes, M, N_MAX, D, 2.0)
        n = c.kernels[name]
        assert (c.kernel_flops[name], c.kernel_bytes[name]) == (n * cost[0], n * cost[1])
    # K1's FLOPs are the block-Gram work the model_flops expression counts,
    # with the Gram's triangle in place of its square
    f1 = k1_cost(M, N_MAX, D, H, BLOCK, 4)[0]
    assert f1 == 2 * M * (H // BLOCK) * (BLOCK * (BLOCK + 1) // 2 + 3 * BLOCK) * D


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_dmtrl_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)]))
    proc = subprocess.run([sys.executable, "-c",
                           f"import torch_dryrun_ranks as r; r.main({str(out)!r}, 'dmtrl')"],
                          env=env, cwd=str(TESTS), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((out / "rank0.json").read_text())


@pytest.mark.parametrize("case", [c[0] for c in ranks_mod.DMTRL_CASES])
def test_fake_world_trace_equals_gloo_round(gloo_counts, case):
    _, names, axes, solver, hoisted = next(c for c in ranks_mod.DMTRL_CASES if c[0] == case)
    with fake_world(4):
        mesh = make_mesh((2, 2), names, device="meta")
        got = ranks_mod.dmtrl_costs(mesh, axes, solver, hoisted).counted()
    assert got == gloo_counts[case]
    assert got["collectives"]["all_gather"] == 1  # delta_b over 'data'
    z = ranks_mod.DMTRL_SIZE
    d_loc = z["d"] // (2 if axes[1] else 1)
    assert got["collective_bytes"]["all_gather"] == z["m"] * d_loc * 4


# src/repro/launch/dryrun_dmtrl.py:66-70, evaluated here as JAX writes it
def _jax_model_flops(m, d, H, block):
    nb = H // block
    per_task = nb * (2 * 2 * block * d + 2 * block * block * d + 2 * block * d)
    return float(m * per_task)


@pytest.mark.parametrize("m,d,H,block", [(4096, 8192, 512, 128), (4096, 100, 192, 64),
                                         (10, 784, 12032, 64), (16, 100, 1984, 64)])
def test_model_flops_is_jax_expression(m, d, H, block):
    assert dryrun_dmtrl.model_flops(m, d, H, block) == _jax_model_flops(m, d, H, block)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_run_writes_an_ok_row(tmp_path, mesh_name, capsys):
    rec = dryrun_dmtrl.run(mesh_name, 512, 64, 256, str(tmp_path), H=64, block=32)
    row = json.loads((tmp_path / f"dmtrl__wstep__{mesh_name}.json").read_text())
    assert rec["status"] == row["status"] == "ok"
    assert row["arch"] == "dmtrl-m512-d256" and row["shape"] == "wstep-H64-B32"
    assert row["model_flops"] == _jax_model_flops(512, 256, 64, 32)
    n_chips = 512 if mesh_name == "multi" else 256
    assert row["useful_flops_ratio"] == pytest.approx(
        row["model_flops"] / (row["flops_per_device"] * n_chips))
    # the full-Gram form over 'model': delta_b gathered over 'data', the
    # Gram and q summed over 'model' (and r over 'pod')
    assert row["collective_counts"] == {"all_gather": 1,
                                        "all_reduce": 3 if mesh_name == "multi" else 2}
    assert "dominant" in capsys.readouterr().out
