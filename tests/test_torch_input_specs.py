"""launch.input_specs against the JAX package's: for every arch and input
shape, the same inputs with the same shapes and dtypes (meta tensors for
ShapeDtypeStructs), shape_applicable's verdict, and every leaf of the
decode cache (the port's init_decode_cache on meta against JAX's
eval_shape of its own)."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import input_specs as jax_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import input_specs as specs

DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.uint32): torch.uint32}


def _same(port, ref, where):
    assert isinstance(port, torch.Tensor) and port.device.type == "meta", where
    assert tuple(port.shape) == tuple(ref.shape), where
    assert port.dtype == DTYPES[jnp.dtype(ref.dtype)], where


def _cache_pairs(port, ref):
    """(port leaf, JAX leaf, where) over a DecodeCache of each package."""
    assert isinstance(port.layers, dict) == isinstance(ref.layers, dict)
    if isinstance(ref.layers, dict):
        assert sorted(port.layers) == sorted(ref.layers)
        yield from ((port.layers[k], ref.layers[k], f"layers/{k}") for k in ref.layers)
    else:
        assert len(port.layers) == len(ref.layers)
        for i, (p, r) in enumerate(zip(port.layers, ref.layers)):
            assert sorted(p) == sorted(r)
            yield from ((p[k], r[k], f"layers/{i}/{k}") for k in r)
    yield port.position, ref.position, "position"
    assert (port.shared is None) == (ref.shared is None)
    for i, (p, r) in enumerate(zip(port.shared or [], ref.shared or [])):
        yield from ((p[k], r[k], f"shared/{i}/{k}") for k in r)
    assert (port.cross is None) == (ref.cross is None)
    for i, (p, r) in enumerate(zip(port.cross or [], ref.cross or [])):
        yield from ((p[j], r[j], f"cross/{i}/{j}") for j in range(2))


@pytest.mark.parametrize("shape_name", list(specs.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, shape_name):
    shape, jshape = specs.INPUT_SHAPES[shape_name], jax_specs.INPUT_SHAPES[shape_name]
    assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == (
        jshape.name, jshape.seq_len, jshape.global_batch, jshape.kind)
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert specs.shape_applicable(cfg, shape) == jax_specs.shape_applicable(jcfg, jshape)
    port, ref = specs.input_specs(cfg, shape), jax_specs.input_specs(jcfg, jshape)
    assert sorted(port) == sorted(ref)
    for k in ref:
        if k == "cache":
            n = 0
            for p, r, where in _cache_pairs(port[k], ref[k]):
                _same(p, r, f"{arch} {shape_name} cache/{where}")
                n += 1
            assert n == len(jax.tree.leaves(ref[k]))
        else:
            _same(port[k], ref[k], f"{arch} {shape_name} {k}")
