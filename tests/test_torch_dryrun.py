"""The port's LM dry run (repro_torch.launch.dryrun) against the JAX dry
run and against real runs.

  * arg_bytes_per_device and model_flops of every arch x input shape x
    mesh equal the JAX dry run's (tests/jax_dryrun_ref.py computes them in
    a process of its own: importing repro.launch.dryrun rewrites
    XLA_FLAGS).
  * The meta trace of one train step at one position equals the cost
    counter over the same step on CPU tensors, exactly: FLOPs, bytes,
    kernel launches by kind (reduced gemma3, qwen3-moe, mamba2, zamba2,
    whisper; remat on); so does that of one sharded prefill and one
    decode tick.
  * decode_cache_shardings gives JAX's cache_shardings leaf for leaf, and
    every traced decode row's collective bytes follow PERF.md's formula.
  * The trace at rank 0 of a fake 4-rank world equals rank 0 of a real
    4-rank gloo world running the step (tests/torch_dryrun_ranks.py, one
    world for the module): FLOPs, bytes, kernels, and collective calls
    and bytes by kind.
  * Traced FLOPs of a reduced dense step against
    repro.roofline.hlo_parse.analyze_hlo's dot FLOPs of JAX's step
    compiled on one CPU device.
"""
import collections
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


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_rows_take_jax_microbatches(jax_rows, arch, mesh_name):
    """A train row's step takes JAX's microbatches: one row a rank above 2e9
    parameters, else one; ZeRO-2 only when asked."""
    cfg, shape = get_config(arch), INPUT_SHAPES["train_4k"]
    rule = dryrun.microbatch_rule(cfg, shape, dryrun.shape_mesh(mesh_name))
    assert rule["mode"] == "train" and "inner_param_specs" not in rule
    assert rule["microbatches"] == jax_rows[f"{arch}|train_4k|{mesh_name}"]["microbatches"]


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_bytes_at_rest_under_train_specs(jax_rows, arch, mesh_name):
    """step_bytes_at_rest is the params and two fp32 moments under JAX's
    train-mode (FSDP) specs, by JAX's own per-device byte count."""
    cfg = get_config(arch)
    want = jax_rows[f"{arch}|train_4k|{mesh_name}"]["at_rest"]
    assert dryrun.step_bytes_at_rest(cfg, dryrun.shape_mesh(mesh_name)) == want


def test_step_bytes_at_rest_fits_the_card():
    """The FSDP specs bring every arch's state at rest under a card's 80 GB
    on (16, 16): kimi-k2 41.46 GB (663.35 GB under serve-mode specs)."""
    mesh = dryrun.shape_mesh("single")
    at_rest = {a: dryrun.step_bytes_at_rest(get_config(a), mesh) / 1e9 for a in ARCH_IDS}
    assert round(at_rest["kimi-k2-1t-a32b"], 2) == 41.46
    assert round(at_rest["gemma3-1b"], 2) == 0.26 and round(at_rest["qwen1_5-32b"], 2) == 5.31
    assert max(at_rest.values()) < 80


def test_scaled_counts_equal_the_full_trace():
    """A step of 4 microbatches counted from its first two equals its whole
    trace: every count and the peak (reduced qwen3-moe, data 2 x model 2,
    remat on)."""
    from repro_torch.core import make_mesh

    cfg = ranks_mod.lm_config("qwen3-moe-30b-a3b")
    shape = InputShape("scaled", 24, 8, "train")
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="meta")
        full = dryrun.trace_step(cfg, shape, mesh, mode="train", microbatches=4)
        scaled = dryrun.trace_step(cfg, shape, mesh, scaled=True, mode="train", microbatches=4)
        one = dryrun.trace_step(cfg, shape, mesh, mode="train", microbatches=1)
    assert scaled.counted() == full.counted()
    assert (scaled.peak_bytes, scaled.ops) == (full.peak_bytes, full.ops)
    assert full.kernels["K3"] == 4 * one.kernels["K3"]
    assert full.collectives["all_gather"] > one.collectives["all_gather"]


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
    _, arch, lay, B, S, m = next(c for c in ranks_mod.LM_CASES if c[0] == case)
    shape, names = ranks_mod.LAYOUTS[lay]
    cfg = ranks_mod.lm_config(arch)
    from repro_torch.core import make_mesh

    with fake_world(math.prod(shape)):
        mesh = make_mesh(shape, names, device="meta")
        assert mesh.distributed and mesh.is_root and mesh.device.type == "meta"
        costs = dryrun.trace_step(cfg, InputShape(case, S, B, "train"), mesh, mode="train",
                                  microbatches=m)
    want = gloo_counts[case]
    assert costs.counted() == want
    assert want["collectives"]["all_gather"] > 0 and want["collective_bytes"]["all_reduce"] > 0
    assert want["collectives"]["reduce_scatter"] > 0


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
    """One row of each status through run_one and the CLI's loop: the train
    and serve shapes traced, long_500k skipped for a full-attention arch."""
    recs = dryrun.run_all(["whisper-tiny"], list(INPUT_SHAPES), ["single"], str(tmp_path),
                          echo=None)
    status = {r["shape"]: r["status"] for r in recs}
    assert status == {"train_4k": "ok", "prefill_32k": "ok", "decode_32k": "ok",
                      "long_500k": "skipped"}
    ok = next(r for r in recs if r["shape"] == "train_4k")
    assert ok["kernel_launches"] == {"K3": 24, "K3-bwd": 12}  # 4 + 4 + 4 a pass, remat
    assert ok["microbatches"] == 1 and ok["arg_bytes_per_device"] > 0
    assert ok["microbatch_counts"] == "traced" and not ok["zero2"]
    assert ok["step_bytes_at_rest"] > ok["arg_bytes_per_device"]
    assert ok["dominant"] in ("compute", "memory", "collective")
    assert ok["collective_counts"]["all_gather"] > 0
    row = json.loads((tmp_path / "whisper-tiny__train_4k__single.json").read_text())
    assert row["flops_per_device"] == ok["flops_per_device"]
    assert "reason" in next(r for r in recs if r["status"] == "skipped")
    serve = {r["shape"]: r for r in recs if r["shape"] in ("prefill_32k", "decode_32k")}
    # the encoder's 4 layers, the decoder's 4 and its 4 cross-attentions; a
    # tick is plain torch
    assert serve["prefill_32k"]["kernel_launches"] == {"K3": 12}
    assert serve["decode_32k"]["kernel_launches"] == {}
    for r in serve.values():
        assert r["fits"] and ok["fits"] and "microbatches" not in r
        assert r["step_bytes_at_rest"] == r["arg_bytes_per_device"]
        assert r["flops_per_device"] > 0 and r["peak_bytes_per_device"] > 0
    # --skip-done leaves finished rows alone
    assert dryrun.run_all(["whisper-tiny"], list(INPUT_SHAPES), ["single"], str(tmp_path),
                          skip_done=True, echo=None) == []


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match_jax(jax_rows, arch, mesh_name):
    """decode_cache_shardings, which the traced decode step and the
    analytic bytes both read, gives every cache leaf JAX's spec from the
    dry run's cache_shardings, at decode_32k and (where it applies)
    long_500k."""
    from repro_torch.launch.input_specs import input_specs
    from repro_torch.models import sharding

    cfg = get_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        shape = INPUT_SHAPES[shape_name]
        cache = input_specs(cfg, shape)["cache"]
        got = sharding.decode_cache_shardings(cfg, dryrun.shape_mesh(mesh_name),
                                              shape.global_batch, cache)
        got = {p: [list(e) if isinstance(e, tuple) else e for e in s.spec]
               for p, s in sharding.cache_items(got)}
        assert got == jax_rows[f"{arch}|{shape_name}|{mesh_name}"]["cache_specs"]


SERVE_SMALL = (InputShape("prefill_small", 40, 2, "prefill"),
               InputShape("decode_small", 40, 2, "decode"))


@pytest.mark.parametrize("arch", META_ARCHS)
def test_serve_meta_trace_equals_cpu_step(arch):
    """The meta trace of one sharded prefill and of one decode tick at one
    position equals the counter over the same steps on CPU tensors,
    exactly: FLOPs, bytes, kernel launches and collectives."""
    import numpy as np
    import torch

    from repro_torch.models import (
        init_decode_cache, init_params, make_sharded_decode_step, make_sharded_prefill,
        sharding,
    )
    from repro_torch.roofline.analysis import CostCounter

    cfg = ranks_mod.lm_config(arch)
    params = init_params(cfg, 0, "cpu")
    mesh = make_host_mesh(1, 1, device="cpu")
    rs = np.random.RandomState(0)
    for shape in SERVE_SMALL:
        meta = dryrun.trace_serve(cfg, shape, make_host_mesh(1, 1, device="meta"))
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "prefill":
            step, pshard, bshard, _ = make_sharded_prefill(cfg, mesh, B, S,
                                                           extra_len=dryrun.SERVE_EXTRA_LEN)
            batch = {"tokens": torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S)))
                     .to(torch.int32)}
            if cfg.is_encoder_decoder:
                batch["frames"] = torch.randn(B, cfg.enc_frames, cfg.d_model,
                                              dtype=torch.bfloat16)
            args = (batch,)
        else:
            step, pshard, _, _ = make_sharded_decode_step(cfg, mesh, B, S)
            args = (torch.from_numpy(rs.randint(0, cfg.vocab_size, (B,))).to(torch.int32),
                    init_decode_cache(cfg, B, S, device="cpu"))
        blocks = sharding.shard_tree(pshard, params)
        with CostCounter() as c:
            step(blocks, *args)
        assert meta.counted() == c.costs.counted(), shape.name
        assert meta.flops > 0 and meta.bytes > 0
        assert bool(meta.kernels) == (shape.kind == "prefill")


DECODE_ROWS = [(a, sh) for a in ARCH_IDS for sh in ("decode_32k", "long_500k")
               if shape_applicable(get_config(a), INPUT_SHAPES[sh])[0]]
# a decode row of every cache layout: gemma3's head_dim split with its
# slots split (long_500k), nemotron's head_dim split with q heads split,
# qwen1.5-4b's with q, k and v replicated, zamba2's kv heads split with its
# slots split and its SSM heads, qwen3-moe's experts, mamba2's SSM heads
LAYOUT_ROWS = (("gemma3-1b", "long_500k"), ("nemotron-4-15b", "decode_32k"),
               ("qwen1_5-4b", "decode_32k"), ("zamba2-2_7b", "long_500k"),
               ("qwen3-moe-30b-a3b", "decode_32k"), ("mamba2-780m", "decode_32k"))


def _decode_bytes(arch, shape, mesh_name):
    """The traced tick's collective bytes at rank 0 of the fake world, and
    PERF.md's formula for it (``torch_serve_ranks.tick_bytes``, bf16)."""
    import torch_serve_ranks as serve_ranks

    cfg = get_config(arch)
    sm = dryrun.shape_mesh(mesh_name)
    with fake_world(math.prod(sm.shape.values())):
        costs = dryrun.trace_serve(cfg, shape, dryrun.make_dryrun_mesh(
            multi_pod=mesh_name == "multi"))
    return (collections.Counter(costs.collective_bytes),
            collections.Counter(serve_ranks.tick_bytes(cfg, sm.shape, shape.global_batch,
                                                       shape.seq_len, 2)))


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch,shape_name", DECODE_ROWS)
def test_decode_row_collectives_follow_the_formula(arch, shape_name, mesh_name):
    """Every traced decode row's collective bytes by kind equal PERF.md's
    per-layer formula: its gathers are the token's embedding columns, q,
    the output blocks along head_dim and the SSM layers' new x columns,
    none of them a cache block; only the partial scores' psum grows with
    the slots a rank holds."""
    traced, formula = _decode_bytes(arch, INPUT_SHAPES[shape_name], mesh_name)
    assert traced == formula


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch,shape_name", LAYOUT_ROWS)
def test_a_tick_gathers_the_same_at_half_the_slots(arch, shape_name, mesh_name):
    """At half the cache's slots a tick gathers the same bytes (no gather
    moves the cache) and still follows the formula."""
    shape = INPUT_SHAPES[shape_name]
    half = InputShape(shape_name + "_half", shape.seq_len // 2, shape.global_batch, "decode")
    full_bytes, _ = _decode_bytes(arch, shape, mesh_name)
    traced, formula = _decode_bytes(arch, half, mesh_name)
    assert traced == formula
    assert traced["all_gather"] == full_bytes["all_gather"]
    assert traced["all_reduce"] <= full_bytes["all_reduce"]


def test_trace_error_is_a_row(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "trace_step", boom)
    rec = dryrun.run_one("gemma3-1b", "train_4k", "single", str(tmp_path))
    assert rec["status"] == "error" and "no such step" in rec["error"]
    assert "Traceback" in rec["traceback"]
