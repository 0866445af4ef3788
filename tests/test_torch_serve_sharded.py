"""The port's sharded serving step (``models.make_sharded_prefill``,
``models.make_sharded_decode_step``: JAX's serve-mode specs and decode
cache layouts over the mesh's process groups) against the JAX package, on
the CPU.

  * Four ranks against JAX's own jitted sharded ``prefill`` and
    ``decode_step`` on 4 fake CPU devices (tests/jax_serve_ref.py, the
    dry run's in_shardings), in every layout of
    tests/torch_serve_ranks.py: data 4, data 2 x model 2, pod 2 x data 2
    and model 4 at batch 8, and data 2 x model 2 at batch 1, where the
    cache's slots split over data. The reduced configs hit every cache
    layout (kv heads split, head_dim split, slots split), replicated
    attention, the MoE's experts split, the SSM heads split (pure and
    hybrid), the vocabulary split and the encoder-decoder's cross cache.
    The gathered logits and every gathered cache leaf after the prefill
    and after each of 3 decode ticks agree within the zoo's forward bar
    (2e-5, fp32). One gloo world and one JAX process for the module, run
    side by side.
  * One position (the local mesh) against the unsharded ``prefill`` and
    ``decode_step``, bit for bit.
  * Each rank's cache blocks have the shapes ``decode_cache_shardings``
    gives, and each decode tick's collective bytes by kind equal PERF.md's
    formula (``torch_serve_ranks.tick_bytes``): none moves a cache block.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import distributed as dist_mod
from repro_torch.launch import dryrun, make_host_mesh
from repro_torch.models import (
    decode_step, init_decode_cache, make_sharded_decode_step, make_sharded_prefill, prefill,
    sharding,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, TESTS)
import torch_serve_ranks as ranks_mod  # noqa: E402

TOL = 2e-5  # the zoo's forward bar (tests/test_torch_train_grads.py TOL)
SEQ, EXTRA, STEPS = ranks_mod.SEQ, ranks_mod.EXTRA, ranks_mod.STEPS
CASE_IDS = [c[0] for c in ranks_mod.CASES]


def configs(arch):
    return (ranks_mod.case_config(get_config(arch), arch),
            ranks_mod.case_config(jax_get_config(arch), arch))


@functools.lru_cache(maxsize=None)
def jax_params_np(arch):
    _, jcfg = configs(arch)
    return jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))


def case_inputs(case, arch, B):
    """The prompt, an encoder-decoder's frames and the tokens of the decode
    ticks, from numpy seed B (the same for every case of one batch)."""
    cfg, _ = configs(arch)
    rs = np.random.RandomState(B)
    out = {"tokens": rs.randint(0, cfg.vocab_size, (B, SEQ)).astype(np.int32),
           "steps": rs.randint(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = (0.5 * rs.randn(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _env(**extra):
    return {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(REPO, "src"), TESTS]),
            **extra}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four gloo ranks and JAX's 4-device process, started together on
    one inputs.npz: (the ranks' json, rank 0's arrays, JAX's arrays)."""
    out = tmp_path_factory.mktemp("serve_ranks")
    arrays = {}
    for arch in ranks_mod.ARCHS:
        for path, a in ranks_mod.flat_paths(jax_params_np(arch)):
            arrays[f"{arch}/params/{path}"] = np.asarray(a)
    for case, arch, _, B in ranks_mod.CASES:
        arrays.update({f"{case}/{k}": v for k, v in case_inputs(case, arch, B).items()})
    np.savez(out / "inputs.npz", **arrays)
    ref = out / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", f"import jax_serve_ref as r; r.main({str(out / 'inputs.npz')!r}, "
         f"{str(ref)!r})"], cwd=TESTS, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS=f"--xla_force_host_platform_device_count={ranks_mod.WORLD}"))
    rank_proc = subprocess.Popen(
        [sys.executable, "-c", f"import torch_serve_ranks as r; r.main({str(out)!r})"],
        cwd=TESTS, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    try:
        _, jerr = jax_proc.communicate(timeout=300)
        _, rerr = rank_proc.communicate(timeout=300)
    finally:
        for p in (jax_proc, rank_proc):
            if p.poll() is None:
                p.kill()
    assert rank_proc.returncode == 0, rerr[-3000:]
    assert jax_proc.returncode == 0, jerr[-3000:]
    res = []
    for r in range(ranks_mod.WORLD):
        with open(out / f"rank{r}.json") as f:
            res.append(json.load(f))
    ours = {case: dict(np.load(out / (case.replace("|", "_") + ".npz"))) for case in CASE_IDS}
    return res, ours, np.load(ref)


@pytest.mark.parametrize("case", CASE_IDS)
def test_four_ranks_equal_jax_sharded_serve(runs, case):
    """The gathered logits of the prefill and of each tick, and every cache
    leaf after the prefill and after the last tick, within 2e-5 of JAX's
    jitted sharded prefill and decode_step; the slots' positions and the
    cache position exactly."""
    _, ours, ref = runs
    key = case.replace("|", "_") + "/"
    theirs = {k[len(key):]: ref[k] for k in ref.files if k.startswith(key)}
    got = ours[case]
    assert sorted(got) == sorted(theirs)
    assert any(k.startswith("prefill/layers") for k in got)
    for k, want in theirs.items():
        have = got[k]
        assert have.shape == want.shape, (k, have.shape, want.shape)
        if want.dtype.kind in "iu" or k.endswith("position"):
            assert np.array_equal(have, want), k
            continue
        err = float(np.max(np.abs(have.astype(np.float64) - want.astype(np.float64))))
        assert err <= TOL, (k, err)


@pytest.mark.parametrize("case", CASE_IDS)
def test_cache_blocks_follow_the_specs(runs, case):
    """Every rank holds its block of each cache leaf at the shape
    ``decode_cache_shardings`` gives (the layer axis, the position and the
    cross cache's heads whole; the rows, the slots, the kv heads or
    head_dim and the SSM heads split as ``decode_cache_pspec`` says), and
    the layout the case is for is hit."""
    res, _, _ = runs
    _, arch, lay, B = next(c for c in ranks_mod.CASES if c[0] == case)
    cfg, _ = configs(arch)
    shape, names = ranks_mod.LAYOUTS[lay]
    mesh = dryrun.ShapeMesh(dict(zip(names, shape)))
    full = init_decode_cache(cfg, B, SEQ + EXTRA, device="meta")
    specs = sharding.decode_cache_shardings(cfg, mesh, B, full)
    want = {p: list(s.shard_shape(t.shape)) for (p, t), (_, s) in
            zip(sharding.cache_items(full), sharding.cache_items(specs))}
    for r in res:
        assert r[case]["blocks"] == want
    split = [p for p, t in sharding.cache_items(full) if list(t.shape) != want[p]]
    assert split, "the case splits no cache leaf"


def test_every_layout_is_hit(runs):
    """The cases between them hold a cache split by kv heads, by head_dim
    and by slots, replicated attention heads, split experts and SSM
    heads, and the cross cache."""
    def spec(arch, lay, B, path):
        cfg, _ = configs(arch)
        shape, names = ranks_mod.LAYOUTS[lay]
        full = init_decode_cache(cfg, B, SEQ + EXTRA, device="meta")
        specs = dict(sharding.cache_items(sharding.decode_cache_shardings(
            cfg, dryrun.ShapeMesh(dict(zip(names, shape))), B, full)))
        return tuple(specs[path].spec)

    assert spec("zamba2-2_7b", "data2_model2", 8, "shared/0/k")[2] == "model"  # (a)
    assert spec("gemma3-1b", "model4", 8, "layers/1/k")[3] == "model"  # (b)
    assert spec("gemma3-1b", "data2_model2", 1, "layers/0/k")[1] == "data"  # (c), local ring
    assert spec("zamba2-2_7b", "data2_model2", 1, "shared/1/k")[1:3] == ("data", "model")
    assert spec("mamba2-780m", "model4", 8, "layers/state")[2] == "model"
    assert spec("whisper-tiny", "data2_model2", 8, "cross/0/0") == ("data", None, None, None)
    qwen, _ = configs("qwen1_5-4b")
    assert qwen.n_heads % 4 and qwen.n_kv_heads % 4  # q, k, v replicated on model 4
    moe, _ = configs("qwen3-moe-30b-a3b")
    assert moe.n_experts % 2 == 0


@pytest.mark.parametrize("case", CASE_IDS)
def test_tick_collectives_follow_the_formula(runs, case):
    """Each tick's collective bytes by kind on every rank equal PERF.md's
    formula (``torch_serve_ranks.tick_bytes``): the scores, q and the
    output blocks, the softmax's combine and the psums that close split
    blocks, and nothing that moves a cache block."""
    res, _, _ = runs
    _, arch, lay, B = next(c for c in ranks_mod.CASES if c[0] == case)
    cfg, _ = configs(arch)
    shape, names = ranks_mod.LAYOUTS[lay]
    want = ranks_mod.tick_bytes(cfg, dict(zip(names, shape)), B, SEQ + EXTRA, 4)
    for r in res:
        for tick in r[case]["tick_collective_bytes"]:
            assert tick == want


ONE_POSITION_ARCHS = ("gemma3-1b", "zamba2-2_7b", "whisper-tiny", "qwen3-moe-30b-a3b",
                      "mamba2-780m")


@pytest.mark.parametrize("arch", ONE_POSITION_ARCHS)
def test_one_position_equals_the_unsharded_serve(arch):
    """On the local mesh the sharded prefill and 3 ticks equal ``prefill``
    and ``decode_step`` bit for bit (logits, every cache leaf, the
    position) and call no collective."""
    cfg, _ = configs(arch)
    B = 2
    inputs = case_inputs(arch, arch, B)
    full = lm_params_from_reference(cfg, jax_params_np(arch), device="cpu")
    tokens = torch.from_numpy(inputs["tokens"])
    frames = torch.from_numpy(inputs["frames"]) if "frames" in inputs else None
    mesh = make_host_mesh(1, 1, device="cpu")
    pstep, pshard, bshard, _ = make_sharded_prefill(cfg, mesh, B, SEQ, extra_len=EXTRA)
    dstep, _, tshard, _ = make_sharded_decode_step(cfg, mesh, B, SEQ + EXTRA)
    params = sharding.shard_tree(pshard, full)
    batch = {"tokens": tokens} if frames is None else {"tokens": tokens, "frames": frames}
    dist_mod.reset_collective_counts()
    logits, cache = pstep(params, {k: bshard[k].shard(v) for k, v in batch.items()})
    ref_logits, ref_cache = prefill(cfg, full, tokens, frames, extra_len=EXTRA)

    def same(a, b):
        assert torch.equal(a[0], b[0])
        for (pa, ta), (pb, tb) in zip(sharding.cache_items(a[1]), sharding.cache_items(b[1])):
            assert pa == pb and torch.equal(ta, tb), pa

    same((logits, cache), (ref_logits, ref_cache))
    for i in range(STEPS):
        tok = torch.from_numpy(inputs["steps"][i])
        logits, cache = dstep(params, tshard.shard(tok), cache)
        ref_logits, ref_cache = decode_step(cfg, full, tok, ref_cache)
        same((logits, cache), (ref_logits, ref_cache))
    assert sum(dist_mod.COLLECTIVES.values()) == 0


def test_steps_refuse_wrong_blocks():
    cfg, _ = configs("gemma3-1b")
    mesh = make_host_mesh(1, 1, device="cpu")
    pstep, *_ = make_sharded_prefill(cfg, mesh, 2, SEQ, extra_len=EXTRA)
    with pytest.raises(ValueError, match="this rank's block"):
        pstep({}, {"tokens": torch.zeros((2, SEQ + 1), dtype=torch.int32)})
    with pytest.raises(ValueError, match="unknown batch entry"):
        pstep({}, {"tokens": torch.zeros((2, SEQ), dtype=torch.int32), "labels": None})
    dstep, *_ = make_sharded_decode_step(cfg, mesh, 2, SEQ + EXTRA)
    with pytest.raises(ValueError, match="token has shape"):
        dstep({}, torch.zeros((3,), dtype=torch.int32), None)
