"""The port's LM dry run (repro_torch.launch.dryrun) against the JAX dry
run and against real runs.

  * arg_bytes_per_device and model_flops of every arch x input shape x
    mesh equal the JAX dry run's (tests/jax_dryrun_ref.py computes them in
    a process of its own: importing repro.launch.dryrun rewrites
    XLA_FLAGS).
  * The meta trace of one train step at one position equals the cost
    counter over the same step on CPU tensors, exactly: FLOPs, bytes,
    kernel launches by kind (reduced gemma3, qwen3-moe, mamba2, zamba2,
    whisper; remat on).
  * The trace at rank 0 of a fake 4-rank world equals rank 0 of a real
    4-rank gloo world running the step (tests/torch_dryrun_ranks.py, one
    world for the module): FLOPs, bytes, kernels, and collective calls
    and bytes by kind.
  * Traced FLOPs of a reduced dense step against
    repro.roofline.hlo_parse.analyze_hlo's dot FLOPs of JAX's step
    compiled on one CPU device.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun, fake_world, make_host_mesh
from repro_torch.launch.input_specs import INPUT_SHAPES, InputShape, shape_applicable

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import torch_dryrun_ranks as ranks_mod  # noqa: E402

MESH_NAMES = ("single", "multi")
# a shape of every kind at a size the CPU runs: the trace and the CPU step
# take the same (B, S)
TRAIN = InputShape("train_small", 40, 2, "train")
META_ARCHS = ("gemma3-1b", "qwen3-moe-30b-a3b", "mamba2-780m", "zamba2-2_7b", "whisper-tiny")


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_dryrun") / "rows.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)]))
    proc = subprocess.run([sys.executable, "-c",
                           f"import jax_dryrun_ref as r; r.main({str(out)!r})"],
                          env=env, cwd=str(TESTS), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arg_bytes_and_model_flops_match_jax(jax_rows, arch, shape_name, mesh_name):
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    want = jax_rows[f"{arch}|{shape_name}|{mesh_name}"]
    assert shape_applicable(cfg, shape)[0] == want["applicable"]
    mesh = dryrun.shape_mesh(mesh_name)
    assert dryrun.arg_bytes_per_device(cfg, shape, mesh) == want["arg_bytes"]
    assert dryrun.model_flops(cfg, shape) == want["model_flops"]


def _cpu_step_costs(cfg, shape):
    """The counter over one sharded step on real CPU tensors, one position."""
    return ranks_mod.lm_costs(cfg, make_host_mesh(1, 1, device="cpu"), shape.global_batch,
                              shape.seq_len)


@pytest.mark.parametrize("arch", META_ARCHS)
def test_meta_trace_equals_cpu_step(arch):
    cfg = ranks_mod.lm_config(arch)
    meta = dryrun.trace_step(cfg, TRAIN, make_host_mesh(1, 1, device="meta"))
    cpu = _cpu_step_costs(cfg, TRAIN)
    assert meta.counted() == cpu.counted()
    assert meta.kernels and meta.flops > 0 and meta.bytes > 0 and meta.peak_bytes > 0
    # the kernels' work is part of the totals; the ops around them add more
    assert 0 < sum(meta.kernel_flops.values()) < meta.flops


def test_step_bytes_at_rest_is_what_the_step_holds():
    """step_bytes_at_rest on one position equals the real params plus both
    fp32 moments; the JAX arg bytes count the moments in the params' dtype."""
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(), dtype="bfloat16")
    from repro_torch.models import init_params
    from repro_torch.train import AdamW
    from repro_torch.train.optimizer import tree_leaves

    params = init_params(cfg, 0, "cpu")
    state = AdamW().init(params)
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(params) + tree_leaves(state.mu) + tree_leaves(state.nu))
    one = dryrun.ShapeMesh({"data": 1, "model": 1})
    assert dryrun.step_bytes_at_rest(cfg, one) == held
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert dryrun.arg_bytes_per_device(cfg, TRAIN, one) == 3 * pbytes


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"), str(TESTS)]))
    proc = subprocess.run([sys.executable, "-c",
                           f"import torch_dryrun_ranks as r; r.main({str(out)!r}, 'lm')"],
                          env=env, cwd=str(TESTS), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((out / "rank0.json").read_text())


@pytest.mark.parametrize("case", [c[0] for c in ranks_mod.LM_CASES])
def test_fake_world_trace_equals_gloo_run(gloo_counts, case):
    _, arch, lay, B, S = next(c for c in ranks_mod.LM_CASES if c[0] == case)
    shape, names = ranks_mod.LAYOUTS[lay]
    cfg = ranks_mod.lm_config(arch)
    from repro_torch.core import make_mesh

    with fake_world(math.prod(shape)):
        mesh = make_mesh(shape, names, device="meta")
        assert mesh.distributed and mesh.is_root and mesh.device.type == "meta"
        costs = dryrun.trace_step(cfg, InputShape(case, S, B, "train"), mesh)
    want = gloo_counts[case]
    assert costs.counted() == want
    assert want["collectives"]["all_gather"] > 0 and want["collective_bytes"]["all_reduce"] > 0


def test_fake_world_refuses_a_live_group_and_cleans_up():
    import torch.distributed as dist

    from repro_torch.core import make_mesh

    with fake_world(256):
        assert dist.get_backend() == "fake" and dist.get_world_size() == 256
        with pytest.raises(RuntimeError, match="default group"):
            with fake_world(4):
                pass
        # the guard stays: a cpu mesh runs over gloo only
        with pytest.raises(ValueError, match="gloo"):
            make_mesh((16, 16), ("data", "model"), device="cpu")
        mesh = dryrun.make_dryrun_mesh()
        assert mesh.shape == {"data": 16, "model": 16} and mesh.coord("model") == 0
        assert all(dist.get_world_size(mesh.group(a)) == 16 for a in ("data", "model"))
    assert not dist.is_initialized()


# the JAX step's dot FLOPs over the port's traced FLOPs at the reduced
# qwen1.5-4b below (2 layers, 4 heads of 64, 2 x 128 tokens, no remat):
# measured 1.05922. Everything but attention agrees to the FLOP. The port
# counts K3's 2 and K3-bwd's 5 products of 2 HD FLOPs per kept (causal)
# pair, S (S + 1) / 2 of them; JAX's chunked attention
# (src/repro/models/attention.py:68) multiplies the whole S x S square,
# masked entries included, in 8 products per layer (its backward recomputes
# the forward's two). The test holds that decomposition exactly and the
# ratio to 1e-4.
HLO_RATIO = 1.05922


def test_traced_flops_against_jax_hlo_parse():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models import init_params as jax_init
    from repro.roofline.hlo_parse import analyze_hlo
    from repro.train.loop import make_train_step
    from repro.train.optimizer import AdamW as JaxAdamW

    arch, B, S = "qwen1_5-4b", 2, 128
    jcfg = jax_config(arch).reduced()
    params = jax.eval_shape(lambda k: jax_init(jcfg, k), jax.random.PRNGKey(0))
    opt = JaxAdamW()
    state = jax.eval_shape(lambda: opt.init(params))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "mask": jax.ShapeDtypeStruct((B, S), jnp.float32)}
    hlo = jax.jit(make_train_step(jcfg, opt)).lower(params, state, batch).compile().as_text()
    jax_flops = analyze_hlo(hlo).dot_flops
    cfg = get_config(arch).reduced()
    costs = dryrun.trace_step(cfg, InputShape("hlo", S, B, "train"),
                              make_host_mesh(1, 1, device="meta"))
    assert set(costs.kernels) == {"K3", "K3-bwd"}
    other = costs.flops - sum(costs.kernel_flops.values())
    square = 2 * B * cfg.n_heads * cfg.head_dim * S * S  # one product over every pair
    assert jax_flops == other + 8 * cfg.n_layers * square
    assert jax_flops / costs.flops == pytest.approx(HLO_RATIO, abs=1e-4)


def test_run_one_rows(tmp_path):
    """One row of each status through run_one and the CLI's loop."""
    recs = dryrun.run_all(["whisper-tiny"], list(INPUT_SHAPES), ["single"], str(tmp_path),
                          echo=None)
    status = {r["shape"]: r["status"] for r in recs}
    assert status == {"train_4k": "ok", "prefill_32k": "analytic", "decode_32k": "analytic",
                      "long_500k": "skipped"}
    ok = next(r for r in recs if r["status"] == "ok")
    assert ok["kernel_launches"] == {"K3": 24, "K3-bwd": 12}  # 4 + 4 + 4 a pass, remat
    assert ok["microbatches"] == 1 and ok["arg_bytes_per_device"] > 0
    assert ok["step_bytes_at_rest"] > ok["arg_bytes_per_device"]
    assert ok["dominant"] in ("compute", "memory", "collective")
    assert ok["collective_counts"]["all_gather"] > 0
    row = json.loads((tmp_path / "whisper-tiny__train_4k__single.json").read_text())
    assert row["flops_per_device"] == ok["flops_per_device"]
    assert "reason" in next(r for r in recs if r["status"] == "analytic")
    # --skip-done leaves finished rows alone
    assert dryrun.run_all(["whisper-tiny"], list(INPUT_SHAPES), ["single"], str(tmp_path),
                          skip_done=True, echo=None) == []


def test_trace_error_is_a_row(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "trace_step", boom)
    rec = dryrun.run_one("gemma3-1b", "train_4k", "single", str(tmp_path))
    assert rec["status"] == "error" and "no such step" in rec["error"]
    assert "Traceback" in rec["traceback"]
