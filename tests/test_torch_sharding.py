"""The port's partition specs (``repro_torch.models.sharding``) and
``param_shapes`` against the JAX package's, and the spec checks, on the CPU.

Specs are metadata: they are compared leaf by leaf with
``repro.models.sharding`` on tests/test_sharding_specs.py's fake meshes
(``single`` 16 x 16, ``multi`` 2 x 16 x 16) for every arch at full size
(``param_shapes`` allocates nothing: kimi-k2's 1T parameters are meta
tensors) in both modes. The multi-rank shard/gather round trips run in the
4-rank world of tests/test_torch_train_sharded.py.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.models.sharding as jsh
import repro.models.transformer as jtf
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.core import distributed as dist_mod
from repro_torch.launch import (
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.models import sharding
from repro_torch.models.transformer import param_shapes

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def jax_flat(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def port_flat(tree):
    return dict(sharding._with_paths(tree))


@functools.lru_cache(maxsize=None)
def shapes_pair(arch):
    return param_shapes(get_config(arch)), jtf.param_shapes(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_match_jax(arch):
    ours, theirs = shapes_pair(arch)
    a, b = port_flat(ours), jax_flat(theirs)
    assert list(a) == list(b)  # the same leaves in the same (sorted) order
    for k in a:
        assert a[k].device.type == "meta", k
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        assert str(a[k].dtype).replace("torch.", "") == np.dtype(b[k].dtype).name, k


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_param_pspecs_match_jax(arch, mesh_name, mode):
    ours, theirs = shapes_pair(arch)
    mesh = FakeMesh(MESHES[mesh_name])
    got = port_flat(sharding.param_pspecs(get_config(arch), ours, mesh, mode=mode))
    want = jax_flat(jsh.param_pspecs(jax_get_config(arch), theirs, mesh, mode=mode),
                    is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert list(got) == list(want)
    for k in got:
        assert isinstance(got[k], sharding.P), k
        assert got[k] == tuple(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["data4"])
@pytest.mark.parametrize("batch", [256, 128, 32, 8, 2, 1])
def test_train_batch_pspec_matches_jax(mesh_name, batch):
    shape = MESHES.get(mesh_name, {"data": 4, "model": 1})
    mesh = FakeMesh(shape)
    got = sharding.train_batch_pspec(mesh, batch)
    assert got == tuple(jsh.train_batch_pspec(mesh, batch))
    dsz = int(np.prod([shape[a] for a in sharding.batch_axes(mesh)]))
    assert (got[0] is None) == (batch % dsz != 0)  # too small: the sequence is split


@pytest.mark.parametrize("arch", ["zamba2-2_7b", "gemma3-1b", "qwen1_5-4b"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", ["attn", "local", "ssm"])
@pytest.mark.parametrize("batch", [128, 1])
def test_decode_cache_pspec_matches_jax(arch, mesh_name, kind, batch):
    mesh = FakeMesh(MESHES[mesh_name])
    got = sharding.decode_cache_pspec(get_config(arch), mesh, batch, kind)
    want = jsh.decode_cache_pspec(jax_get_config(arch), mesh, batch, kind)
    assert list(got) == list(want)
    for k in got:
        assert got[k] == tuple(want[k]), (k, got[k], want[k])


def test_spec_form_follows_jax():
    P = jax.sharding.PartitionSpec
    for entries in [(("data",), None), (("pod", "data"), None), ((), "model"), (["data"],),
                    (None, ("model", "data")), ()]:
        assert sharding.P(*entries) == tuple(P(*entries)), entries
    assert repr(sharding.P(None, "model")) == "P(None, 'model')"


def test_specs_that_do_not_fit_raise():
    """No leaf is quietly replicated: a spec naming an axis the mesh lacks,
    one axis twice, or a dim its axes do not divide raises."""
    mesh = dist_mod.Mesh({"data": 2, "model": 2}, "cpu")
    with pytest.raises(ValueError, match="lacks"):
        sharding.NamedSharding(mesh, sharding.P(None, "pod"))
    with pytest.raises(ValueError, match="twice"):
        sharding.NamedSharding(mesh, sharding.P("model", "model"))
    s = sharding.NamedSharding(mesh, sharding.P(None, ("data", "model")))
    with pytest.raises(ValueError, match="does not split"):
        s.shard(torch.zeros(3, 6))
    with pytest.raises(ValueError, match="more entries"):
        s.shard_shape((4,))
    assert s.shard_shape((3, 8)) == (3, 2)
    # a mesh of 2 positions without process groups cannot gather
    with pytest.raises(RuntimeError, match="no process group"):
        s.gather(torch.zeros(3, 2))
    # the specs name 'model' even at size 1: a mesh without the axis cannot hold them
    cfg = get_config("gemma3-1b").reduced()
    with pytest.raises(ValueError, match="lacks"):
        sharding.param_shardings(cfg, param_shapes(cfg), dist_mod.Mesh({"data": 1}, "cpu"))
    with pytest.raises(ValueError, match="mode"):
        sharding.param_pspecs(cfg, param_shapes(cfg), FakeMesh({"model": 1}), mode="fsdp")


def test_stacked_dim_sharded_refuses_a_layer_gather():
    mesh = dist_mod.Mesh({"data": 1, "model": 1}, "cpu")
    s = sharding.NamedSharding(mesh, sharding.P("data", None))
    with pytest.raises(ValueError, match="stacked layer dim"):
        s.gather_grad(torch.zeros(3), lead=1)


def test_shard_and_gather_on_one_position():
    """On the local mesh a block is a copy of the whole leaf (updating it
    leaves the leaf alone) and gather is the identity; no collective."""
    mesh = make_host_mesh(1, 1, device="cpu")
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    from repro_torch.models import init_params

    full = init_params(cfg, 0, "cpu")
    sh = sharding.param_shardings(cfg, param_shapes(cfg), mesh)
    dist_mod.reset_collective_counts()
    blocks = sharding.shard_tree(sh, full)
    back = sharding.gather_tree(sh, blocks)
    for a, b, c in zip(*(sharding.tree_leaves(t) for t in (full, blocks, back))):
        assert torch.equal(a, b) and b is c and b.data_ptr() != a.data_ptr()
    assert sum(dist_mod.COLLECTIVES.values()) == 0
    assert sh["layers"]["moe"]["w_up"].spec == (None, "model", None, None)


def test_mesh_makers_on_one_process():
    mesh = make_host_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    with pytest.raises(RuntimeError, match="256"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(2, 2, device="cpu")
    # the H100 SXM data sheet's figures, not the TPU's
    assert (PEAK_FLOPS_BF16, HBM_BW, NVLINK_BW) == (989e12, 3.35e12, 450e9)


def test_mesh_makers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh(1, 1)
