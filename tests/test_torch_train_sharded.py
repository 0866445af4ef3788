"""The port's sharded LM train step (``train.loop.make_sharded_train_step``
over ``models/sharding.py`` and the differentiable collectives of
``core/distributed.py``) against the JAX package, on the CPU.

JAX's own sharded step raises ``ShardingTypeError`` at the embedding gather
on every multi-device mesh of the installed jax (ROADMAP RC6), so:
  * one position is held against JAX's ``make_sharded_train_step`` on
    ``jax.make_mesh((1, 1), ("data", "model"))`` (five reduced archs, 2
    steps on a 4 x 24 batch with masked positions; metrics 2e-5, params
    2 lr, moments 1e-6), and against the port's ``make_train_step`` bit
    for bit;
  * four ranks are held against JAX's jitted ``make_train_step`` on the
    global batch, which computes the same function (metrics 2e-5, moments
    1e-6, params 5e-4: an AdamW step moves an entry by about
    lr g / (|g| + eps), so an entry whose gradient is near 0 may move
    apart by a part of lr), and against the port's one-process step.

The multi-rank cases run in one 4-rank gloo world that a module fixture
spawns once (tests/torch_sharded_ranks.py: data 4, data 2 x model 2, pod 2
x data 2 and model 4 at batch 8, data 4 at batch 2 with the sequence
split; serve mode, train mode (FSDP), train mode with 2 microbatches and
with ZeRO-2, each against JAX's make_train_step with the same
microbatches; the mesh makers, the differentiable gathers and the
reduce-scatter, shard/gather round trips, the remat probe and the counts
of a step split over model 4); the params are JAX's init, written for the
ranks to an npz.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models.sharding import param_pspecs as jax_param_pspecs
from repro.train import AdamW as JaxAdamW
from repro.train.loop import make_sharded_train_step as jax_make_sharded_train_step
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core import distributed as dist_mod
from repro_torch.launch import make_host_mesh
from repro_torch.models import sharding
from repro_torch.train import AdamW
from repro_torch.train.loop import make_sharded_train_step, make_train_step
from repro_torch.train.optimizer import tree_leaves, tree_map

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_sharded_ranks as ranks_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, STEPS, OPT = ranks_mod.SEQ, ranks_mod.STEPS, ranks_mod.OPT
LR = OPT["lr"]
TOL_METRIC = 2e-5
TOL_PARAM = 2 * LR
TOL_MOMENT = 1e-6
# four ranks: the sums' order differs from one process's, and a handful of
# entries whose gradient is near 0 move apart by up to about 1.2e-4 in two
# steps; an update that is missing or misplaced moves them by about lr
TOL_PARAM_RANKS = 5e-4
ONE_POSITION_ARCHS = ("gemma3-1b", "qwen3-moe-30b-a3b", "mamba2-780m", "zamba2-2_7b",
                      "whisper-tiny")
METRICS = ("ce", "aux_loss", "grad_norm", "lr", "loss")


def pair(arch):
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def jax_params_np(arch):
    _, jcfg = pair(arch)
    return jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))


def make_batch(arch, B):
    """tokens, labels and a mask with about a quarter of the positions
    masked (a whole row masked in a batch of 8), plus an encoder-decoder's
    frames, from numpy seed B."""
    cfg, _ = pair(arch)
    rs = np.random.RandomState(B)
    out = {"tokens": rs.randint(0, cfg.vocab_size, (B, SEQ)).astype(np.int32),
           "labels": rs.randint(0, cfg.vocab_size, (B, SEQ)).astype(np.int32),
           "mask": (rs.rand(B, SEQ) > 0.25).astype(np.float32)}
    if B >= 8:
        out["mask"][5] = 0.0
    if cfg.is_encoder_decoder:
        out["frames"] = (0.5 * rs.randn(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def to_port(arch):
    cfg, _ = pair(arch)
    return lm_params_from_reference(cfg, jax_params_np(arch), device="cpu")


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def metrics_of(m):
    return {k: float(m[k]) for k in METRICS}


@functools.lru_cache(maxsize=None)
def jax_steps(arch, B, microbatches=1):
    """JAX's jitted make_train_step on the global batch: the metrics of each
    step and the params and both moments after the last."""
    _, jcfg = pair(arch)
    jopt = JaxAdamW(**OPT)
    params = jax.tree.map(jnp.asarray, jax_params_np(arch))
    state = jopt.init(params)
    batch = {k: jnp.asarray(v) for k, v in make_batch(arch, B).items()}
    step = jax.jit(jax_make_train_step(jcfg, jopt, microbatches=microbatches))
    hist = []
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        hist.append(metrics_of(m))
    return hist, dict(flat(jax.tree.map(np.asarray, params))), dict(
        flat(jax.tree.map(np.asarray, state.mu))), dict(flat(jax.tree.map(np.asarray, state.nu)))


@functools.lru_cache(maxsize=None)
def port_steps(arch, B, microbatches=1):
    """The port's one-process make_train_step on the global batch."""
    cfg, _ = pair(arch)
    opt = AdamW(**OPT)
    params = to_port(arch)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(arch, B).items()}
    step = make_train_step(cfg, opt, microbatches)
    hist = []
    for _ in range(STEPS):
        params, state, m = step(params, state, batch)
        hist.append(metrics_of(m))
    return hist, {k: v.numpy() for k, v in flat(params)}


def jax_spec_bytes(arch, mode, mesh_shape, dtype_of=None):
    """Per-device bytes of the reduced arch's params under JAX's specs: the
    formula of src/repro/launch/dryrun.py ``_bytes_per_device``."""
    import repro.models.transformer as jtf

    class FakeMesh:
        shape = dict(mesh_shape)

    _, jcfg = pair(arch)
    shapes = jtf.param_shapes(jcfg)
    specs = jax_param_pspecs(jcfg, shapes, FakeMesh(), mode=mode)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes),
                          jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, tuple))):
        itemsize = (dtype_of or (lambda l: l.dtype.itemsize))(leaf)
        denom = 1
        for entry in tuple(spec):
            for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
                denom *= mesh_shape[a]
        total += int(np.prod(leaf.shape)) * itemsize // max(denom, 1)
    return total


def mesh_shape_of(layout):
    shape, names = ranks_mod.LAYOUTS[layout]
    return dict(zip(names, shape))


# ---------------------------------------------------------------------------
# one position: the local mesh against JAX's sharded step on one device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ONE_POSITION_ARCHS)
def test_one_position_equals_jax_sharded_step(arch):
    cfg, jcfg = pair(arch)
    B = 4
    batch_np = make_batch(arch, B)
    jopt, opt = JaxAdamW(**OPT), AdamW(**OPT)

    # plain arrays: the jitted step places them by its in_shardings. Arrays
    # that carry the step's NamedShardings (placed with them, or its own
    # outputs) hit RC6 even on one device, so each step's outputs go back
    # through numpy before the next
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep = jax_make_sharded_train_step(jcfg, jopt, jmesh, B, SEQ)[0]
    jparams = jax.tree.map(jnp.asarray, jax_params_np(arch))
    jstate = jopt.init(jparams)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}

    mesh = make_host_mesh(1, 1, device="cpu")
    assert not mesh.distributed and mesh.shape == {"data": 1, "model": 1}
    step, pshard, opt_shard, bshard = make_sharded_train_step(cfg, opt, mesh, B, SEQ)
    params = sharding.shard_tree(pshard, to_port(arch))
    state = opt.init(params)
    batch = {k: bshard[k].shard(torch.from_numpy(v)) for k, v in batch_np.items()}
    ref_params = to_port(arch)
    ref_state = opt.init(ref_params)
    ref_step = make_train_step(cfg, opt)
    ref_batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    dist_mod.reset_collective_counts()
    for i in range(STEPS):
        jparams, jstate, jm = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)),
                                           jstep(jparams, jstate, jbatch))
        params, state, m = step(params, state, batch)
        ref_params, ref_state, rm = ref_step(ref_params, ref_state, ref_batch)
        for k in METRICS:
            assert abs(float(m[k]) - float(jm[k])) <= TOL_METRIC, (i, k, float(m[k]), float(jm[k]))
            assert float(m[k]) == float(rm[k]), (i, k)
    assert sum(dist_mod.COLLECTIVES.values()) == 0  # the local mesh calls none
    jp = dict(flat(jax.tree.map(np.asarray, jparams)))
    jmu = dict(flat(jax.tree.map(np.asarray, jstate.mu)))
    jnu = dict(flat(jax.tree.map(np.asarray, jstate.nu)))
    got, ref = dict(flat(params)), dict(flat(ref_params))
    assert sorted(got) == sorted(jp)
    for k in got:
        assert torch.equal(got[k], ref[k]), k
        assert max_err(got[k].numpy(), jp[k]) <= TOL_PARAM, k
    e_mom = 0.0
    for ours, theirs, name in ((state.mu, jmu, "mu"), (state.nu, jnu, "nu")):
        for k, t in flat(ours):
            e_mom = max(e_mom, max_err(t.numpy(), theirs[k]))
            assert max_err(t.numpy(), theirs[k]) <= TOL_MOMENT, (name, k)
    print(f"{arch}: params {max(max_err(got[k].numpy(), jp[k]) for k in got):.2e}, "
          f"moments {e_mom:.2e}")
    for a, b in zip(tree_leaves(state.mu), tree_leaves(ref_state.mu)):
        assert torch.equal(a, b)
    assert int(state.step) == int(jstate.step) == STEPS


def test_step_refuses_a_batch_that_is_not_its_block():
    cfg, _ = pair("gemma3-1b")
    opt = AdamW(**OPT)
    mesh = make_host_mesh(1, 1, device="cpu")
    step, pshard, _, _ = make_sharded_train_step(cfg, opt, mesh, 4, SEQ)
    params = sharding.shard_tree(pshard, to_port("gemma3-1b"))
    batch = {k: torch.from_numpy(v) for k, v in make_batch("gemma3-1b", 8).items()}
    with pytest.raises(ValueError, match="block"):
        step(params, opt.init(params), batch)


def test_step_refuses_a_mesh_without_the_model_axis():
    """JAX's specs name 'model' even at size 1; a mesh without the axis
    cannot hold them."""
    cfg, _ = pair("gemma3-1b")
    mesh = dist_mod.make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        make_sharded_train_step(cfg, AdamW(**OPT), mesh, 4, SEQ)


# ---------------------------------------------------------------------------
# four ranks: one gloo world for every multi-rank case
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_ranks")
    arrays = {}
    needed = {}
    for _, arch, _, B, _ in ranks_mod.STEP_CASES:
        needed.setdefault(arch, set()).add(B)
    needed.setdefault("gemma3-1b", set()).add(8)  # the remat probe
    for arch, batches in needed.items():
        for path, a in flat(jax_params_np(arch)):
            arrays[f"{arch}/params/{path}"] = np.asarray(a)
        for B in batches:
            for k, v in make_batch(arch, B).items():
                arrays[f"{arch}/b{B}/{k}"] = v
    np.savez(out / "inputs.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])}
    proc = subprocess.run(
        [sys.executable, "-c", f"import torch_sharded_ranks as r; r.main({str(out)!r})"],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = []
    for r in range(ranks_mod.WORLD):
        with open(out / f"rank{r}.json") as f:
            res.append(json.load(f))
    return out, res


def test_ranks_agree(world):
    """Each layout gives every rank its own coordinates, and every rank
    reports the same metrics and the same gathered params."""
    _, res = world
    for lay, (shape, names) in ranks_mod.LAYOUTS.items():
        coords = sorted(tuple(r["coords"][lay][a] for a in names) for r in res)
        assert coords == sorted(np.ndindex(*shape)), lay
    for case in res[0]["steps"]:
        for r in res[1:]:
            assert r["steps"][case]["metrics"] == res[0]["steps"][case]["metrics"], case
            assert r["steps"][case]["digest"] == res[0]["steps"][case]["digest"], case


STEP_PARAMS = [c[:4] for c in ranks_mod.STEP_CASES]
STEP_IDS = [c[0] for c in ranks_mod.STEP_CASES]
OPTIONS = {c[0]: c[4] for c in ranks_mod.STEP_CASES}


@pytest.mark.parametrize("case,arch,layout,B", STEP_PARAMS, ids=STEP_IDS)
def test_four_ranks_equal_the_single_device_step(world, case, arch, layout, B):
    """Two steps on four ranks against JAX's and the port's make_train_step
    on the global batch with the case's microbatches (serve or train mode,
    ZeRO-2 or not: the same function)."""
    out, res = world
    got = res[0]["steps"][case]
    m = OPTIONS[case]["microbatches"]
    jhist, jp, jmu, jnu = jax_steps(arch, B, m)
    phist, pp = port_steps(arch, B, m)
    mesh_shape = mesh_shape_of(layout)
    dp = tuple(a for a in ("pod", "data") if a in mesh_shape)
    dsz = int(np.prod([mesh_shape[a] for a in dp]))
    want_bspec = [dp if len(dp) > 1 else dp[0], None] if B % dsz == 0 else [
        None, dp if len(dp) > 1 else dp[0]]
    assert [tuple(e) if isinstance(e, list) else e for e in got["bspec"]] == want_bspec
    assert got["step"] == STEPS
    for i in range(STEPS):
        for k in METRICS:
            assert abs(got["metrics"][i][k] - jhist[i][k]) <= TOL_METRIC, (i, k)
            assert abs(got["metrics"][i][k] - phist[i][k]) <= TOL_METRIC, (i, k)
    arrays = np.load(out / (case.replace("|", "_") + ".npz"))
    e_param = e_port = e_mom = 0.0
    for path in jp:
        ours = arrays[f"params/{path}"]
        assert ours.shape == jp[path].shape, path
        e_param = max(e_param, max_err(ours, jp[path]))
        e_port = max(e_port, max_err(ours, pp[path]))
        assert max_err(ours, jp[path]) <= TOL_PARAM_RANKS, path
        assert max_err(ours, pp[path]) <= TOL_PARAM_RANKS, path
        for name, theirs in (("mu", jmu), ("nu", jnu)):
            e = max_err(arrays[f"{name}/{path}"], theirs[path])
            e_mom = max(e_mom, e)
            assert e <= TOL_MOMENT, (name, path)
    e_metric = max(abs(got["metrics"][i][k] - jhist[i][k]) for i in range(STEPS) for k in METRICS)
    print(f"{case}: metrics {e_metric:.2e}, params {e_param:.2e} (port {e_port:.2e}), "
          f"moments {e_mom:.2e}")
    if mesh_shape["model"] > 1:
        assert got["model_sharded"], "no leaf is sharded over model"


@pytest.mark.parametrize("case,arch,layout,B", STEP_PARAMS, ids=STEP_IDS)
def test_each_rank_holds_its_spec_bytes(world, case, arch, layout, B):
    """Params and both moments take the bytes JAX's specs of the case's mode
    give one device (the moments in fp32): serve, or train (FSDP)."""
    _, res = world
    mesh_shape = mesh_shape_of(layout)
    mode = OPTIONS[case]["mode"]
    want_params = jax_spec_bytes(arch, mode, mesh_shape)
    want_moment = jax_spec_bytes(arch, mode, mesh_shape, dtype_of=lambda l: 4)
    for r in res:
        held = r["steps"][case]["held"]
        assert held == {"params": want_params, "mu": want_moment, "nu": want_moment}, case


def test_moe_aux_loss_is_the_whole_batch(world):
    """qwen3-moe on data 4: the summed aux loss is JAX's over the global
    batch; a rank's own E sum f p (its rows alone) is not."""
    _, res = world
    case = "qwen3-moe-30b-a3b|data4|8"
    jhist, *_ = jax_steps("qwen3-moe-30b-a3b", 8)
    for r in res:
        assert abs(r["steps"][case]["metrics"][0]["aux_loss"] - jhist[0]["aux_loss"]) <= TOL_METRIC
    local = [r["steps"][case]["local_aux"] for r in res]
    assert max(abs(a - jhist[0]["aux_loss"]) for a in local) > 100 * TOL_METRIC, local


def test_grad_norm_counts_replicated_leaves_once(world):
    """gemma3 on data 2 x model 2: wk and wv (one kv head) are replicated,
    wq and wo sharded, in the same layer; the norm is JAX's."""
    _, res = world
    case = "gemma3-1b|data2_model2|8"
    sharded = set(res[0]["steps"][case]["model_sharded"])
    assert {"layers/attn/wq", "layers/attn/wo"} <= sharded
    assert not {"layers/attn/wk", "layers/attn/wv"} & sharded
    jhist, *_ = jax_steps("gemma3-1b", 8)
    for i in range(STEPS):
        assert abs(res[0]["steps"][case]["metrics"][i]["grad_norm"]
                   - jhist[i]["grad_norm"]) <= TOL_METRIC


def test_gather_on_use_under_remat(world):
    """The train-mode (FSDP) step on data 2 x model 2. Under remat autograd
    keeps no layer matrix gathered over the batch axes: none is saved
    outside the checkpointed bodies and none is alive when the backward
    starts. Each step gathers every FSDP layer leaf twice (forward and
    recompute), embed and lm_head once, and the embedding rows once over
    model; each gather's backward is one reduce-scatter. Without remat the
    same probe finds every gathered matrix alive and saved."""
    _, res = world
    for r in res:
        on, off = r["remat"]["True"], r["remat"]["False"]
        n_layer, n_matrix = len(on["sharded_layer_leaves"]), len(on["matrix_leaves"])
        assert n_matrix >= 4 and on["top_sharded"] == ["embed", "lm_head"]
        assert on["saved_slice_shapes"] == []
        assert on["alive_at_backward"] == 0
        assert on["collectives"]["all_gather"] == 2 * on["layers"] * n_layer + 2 + 1
        assert on["collectives"]["reduce_scatter"] == on["layers"] * n_layer + 2
        assert off["alive_at_backward"] == off["layers"] * n_matrix
        assert off["saved_slice_shapes"] == on["slice_shapes"]
        assert off["collectives"]["all_gather"] == off["layers"] * n_layer + 2 + 1


@pytest.mark.parametrize("arch", ranks_mod.ROUNDTRIP_ARCHS)
@pytest.mark.parametrize("layout", list(ranks_mod.LAYOUTS))
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_shard_gather_round_trip(world, arch, layout, mode):
    """gather(shard(t)) == t bit for bit for every leaf, and each rank holds
    the per-device bytes of JAX's specs."""
    _, res = world
    want = jax_spec_bytes(arch, mode, mesh_shape_of(layout))
    for r in res:
        rt = r["round_trips"][f"{arch}|{layout}|{mode}"]
        assert rt["equal"]
        assert rt["held"] == want
        assert rt["sharded_leaves"] > 0
        batch_positions = np.prod([mesh_shape_of(layout).get(a, 1) for a in ("pod", "data")])
        if mode == "train" and batch_positions > 1:  # FSDP over the batch axes holds less
            assert rt["held"] < r["round_trips"][f"{arch}|{layout}|serve"]["held"]


def test_mesh_makers(world):
    _, res = world
    for r in res:
        mk = r["makers"]
        assert mk["host_shape"] == {"data": 2, "model": 2} and mk["host_distributed"]
        assert mk["host_coords"] == mk["ref_coords"]
        assert mk["host_groups"] == mk["ref_groups"]
        assert "256" in mk["production"] and "4" in mk["production"]
        assert "512" in mk["production_multi"]


def test_all_gather_backward(world):
    """AllGather over data (2 positions): the full tensor is the blocks in
    data order and its backward hands each rank its block of the gradient
    as it is (1 + data coord), AllGatherSum's the sum over the axis (1 + 2);
    psum_scatter, one reduce_scatter, sums over the axis (1 + 2 = 3 times
    the weights) and keeps this rank's rows, and along dim 1 equals psum
    then the block."""
    _, res = world
    for r in res:
        c = r["coords"]["data2_model2"]["data"]
        gb = r["gather_backward"]
        m = r["coords"]["data2_model2"]["model"]
        blocks = [np.full((2, 3), float(2 * d + m)) for d in range(2)]  # rank = 2 data + model
        np.testing.assert_array_equal(gb["gather"]["full"], np.concatenate(blocks))
        np.testing.assert_array_equal(gb["gather"]["grad"], np.full((2, 3), c + 1.0))
        np.testing.assert_array_equal(gb["gather_sum_grad"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(gb["psum_scatter"],
                                      3.0 * np.arange(12.0).reshape(4, 3)[2 * c:2 * c + 2])
        np.testing.assert_array_equal(gb["psum_scatter_dim1"], gb["psum_then_block_dim1"])
        assert gb["scatter_calls"] == {"reduce_scatter": 2, "all_reduce": 1}
        want = np.concatenate([np.arange(6.0).reshape(2, 3) + 10 * d for d in range(2)], axis=1)
        np.testing.assert_array_equal(gb["dim1"], want)


@pytest.mark.parametrize("arch", ranks_mod.COUNT_ARCHS)
def test_model_split_flops_per_rank(world, arch):
    """Split over model 4, each rank's step does at most 0.4 of the FLOPs of
    the one-position step on the same batch (a quarter of every split
    product; the router, replicated kv heads and B/C projections, and the
    norms stay whole), and launches the same kernels as often."""
    from repro_torch.launch import dryrun, make_host_mesh
    from repro_torch.launch.input_specs import InputShape

    _, res = world
    cfg = ranks_mod.reduced(arch)
    one = dryrun.trace_step(cfg, InputShape("count", SEQ, 8, "train"),
                            make_host_mesh(1, 1, device="meta"), mode="serve", microbatches=1)
    for r in res:
        got = r["split_counts"][arch]
        print(f"{arch}: {got['flops']} FLOP a rank at model 4 against {one.flops} "
              f"({got['flops'] / one.flops:.3f})")
        assert got["flops"] <= 0.4 * one.flops
        assert got["kernels"] == dict(one.kernels)


def test_step_refuses_microbatches_that_do_not_split():
    """B / m must split over the batch axes, and B over m."""
    from repro_torch.launch import fake_world

    cfg, _ = pair("gemma3-1b")
    opt = AdamW(**OPT)
    with pytest.raises(ValueError, match="microbatches"):
        make_sharded_train_step(cfg, opt, make_host_mesh(1, 1, device="cpu"), 4, SEQ,
                                microbatches=3)
    with fake_world(4):
        mesh = dist_mod.make_mesh((4, 1), ("data", "model"), device="meta")
        make_sharded_train_step(cfg, opt, mesh, 8, SEQ, mode="train", microbatches=2)
        with pytest.raises(ValueError, match="does not split over the batch axes"):
            make_sharded_train_step(cfg, opt, mesh, 8, SEQ, mode="train", microbatches=4)


def test_zero2_specs_must_be_the_param_specs_less_batch_axes():
    """inner_param_specs and grad_specs may leave out batch axes of the
    param specs, nothing else; grad_specs keeps the inner specs' axes."""
    from repro_torch.launch import fake_world
    from repro_torch.models.transformer import param_shapes

    cfg, _ = pair("gemma3-1b")
    opt = AdamW(**OPT)
    with fake_world(4):
        mesh = dist_mod.make_mesh((2, 2), ("data", "model"), device="meta")
        shapes = param_shapes(cfg)
        serve = sharding.param_pspecs(cfg, shapes, mesh, "serve")
        train = sharding.param_pspecs(cfg, shapes, mesh, "train")
        make_sharded_train_step(cfg, opt, mesh, 8, SEQ, mode="train", microbatches=2,
                                inner_param_specs=serve, grad_specs=train)
        with pytest.raises(ValueError, match="less some batch axes"):
            make_sharded_train_step(cfg, opt, mesh, 8, SEQ, mode="serve",
                                    inner_param_specs=train)
        replicated = sharding.tree_map(lambda s: sharding.P(*((None,) * len(s))), serve)
        with pytest.raises(ValueError, match="less some batch axes"):
            make_sharded_train_step(cfg, opt, mesh, 8, SEQ, mode="train",
                                    inner_param_specs=replicated)
        with pytest.raises(ValueError, match="every batch axis"):
            make_sharded_train_step(cfg, opt, mesh, 8, SEQ, mode="train",
                                    inner_param_specs=train, grad_specs=serve)
