"""The JAX dry run's analytic numbers for every (arch x input shape x mesh),
in a process of its own: importing repro.launch.dryrun rewrites XLA_FLAGS
(src/repro/launch/dryrun.py:1-4), so the test runs

    python -c "import jax_dryrun_ref as r; r.main(OUT_JSON)"   # tests/ on sys.path

with DRYRUN_XLA_FLAGS set to one host device. For each row it writes
``arg_bytes`` from the package's own ``_bytes_per_device`` over
``param_pspecs`` (train-mode specs, times 3, for a train shape; serve-mode
otherwise) and, for a decode shape, the cache's leaves under the specs
``lower_step`` gives them (src/repro/launch/dryrun.py:155-186, with
PartitionSpecs on a shape-only mesh in place of NamedShardings), and
``model_flops`` from the formulas of ``lower_step`` with the package's
``active_param_count``; for a train shape also ``at_rest`` (the params and
two fp32 moments under train-mode specs, by the same ``_bytes_per_device``)
and ``microbatches`` (``lower_step``'s rule); for a decode shape also
``cache_specs``, each cache leaf's spec by path. Not collected by pytest
(no test_ prefix).
"""
import json
import sys


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def cache_specs(cfg, cache, mesh, batch):
    """The PartitionSpec tree of a DecodeCache, as lower_step's
    cache_shardings builds its NamedShardings."""
    import repro.models.transformer as tf
    from jax.sharding import PartitionSpec as P
    from repro.models.sharding import decode_cache_pspec, train_batch_pspec

    kinds = cfg.layer_kinds()
    if isinstance(cache.layers, dict):
        kind = "ssm" if cfg.arch_type == "ssm" else "attn"
        spec = decode_cache_pspec(cfg, mesh, batch, kind)
        layers = {k: P(*((None,) + tuple(spec[k]))) for k in cache.layers}
    else:
        layers = []
        for i, k in enumerate(kinds):
            kind = "ssm" if k == "ssm" else ("local" if k == "local" else "attn")
            spec = decode_cache_pspec(cfg, mesh, batch, kind)
            layers.append({kk: spec[kk] for kk in cache.layers[i]})
    shared = None
    if cache.shared is not None:
        spec = decode_cache_pspec(cfg, mesh, batch, "attn")
        shared = [{kk: spec[kk] for kk in c} for c in cache.shared]
    cross = None
    if cache.cross is not None:
        ns = P(train_batch_pspec(mesh, batch)[0], None, None, None)
        cross = [(ns, ns) for _ in cache.cross]
    return tf.DecodeCache(layers, P(), shared, cross)


def cache_items(cache):
    """(path, leaf) of a JAX DecodeCache (arrays or specs), named as the
    port's ``repro_torch.models.sharding.cache_items`` names them."""
    from jax.sharding import PartitionSpec as P

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)) and not isinstance(node, P):
            for i, n in enumerate(node):
                yield from walk(n, f"{path}/{i}")
        else:
            yield path, node

    yield from walk(cache.layers, "layers")
    yield "position", cache.position
    if cache.shared is not None:
        yield from walk(cache.shared, "shared")
    if cache.cross is not None:
        yield from walk(cache.cross, "cross")


def spec_list(spec):
    """A PartitionSpec as JSON: each entry None, a name or a list of names."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def main(out_path):
    import jax
    from jax.sharding import PartitionSpec as P

    import jax.numpy as jnp
    import numpy as np
    import repro.launch.dryrun as dr
    import repro.models.transformer as tf
    from repro.configs import ARCH_IDS, get_config
    from repro.launch.input_specs import INPUT_SHAPES, input_specs, shape_applicable
    from repro.models.sharding import param_pspecs, train_batch_pspec

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        pshapes = tf.param_shapes(cfg)
        n_active = cfg.active_param_count()
        for shape_name, shape in INPUT_SHAPES.items():
            tokens = shape.global_batch * shape.seq_len
            for mesh_name, mshape in MESHES.items():
                mesh = FakeMesh(mshape)
                row = {"applicable": shape_applicable(cfg, shape)[0]}
                if shape.kind == "train":
                    specs = param_pspecs(cfg, pshapes, mesh, mode="train")
                    row["arg_bytes"] = dr._bytes_per_device(pshapes, specs, mesh) * 3
                    row["model_flops"] = 6.0 * n_active * tokens
                    # params and two fp32 moments under train-mode specs
                    f32 = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, jnp.float32),
                                       pshapes)
                    row["at_rest"] = (dr._bytes_per_device(pshapes, specs, mesh)
                                      + 2 * dr._bytes_per_device(f32, specs, mesh))
                    # lower_step's microbatch rule (its default, no env overrides)
                    b0 = train_batch_pspec(mesh, shape.global_batch)[0]
                    b0 = (b0,) if isinstance(b0, str) else (b0 or ())
                    n_dp = int(np.prod([mesh.shape[a] for a in b0])) if b0 else 1
                    b_loc = max(shape.global_batch // max(n_dp, 1), 1)
                    row["microbatches"] = max(1, b_loc) if cfg.param_count() > 2e9 else 1
                else:
                    specs = param_pspecs(cfg, pshapes, mesh, mode="serve")
                    row["arg_bytes"] = dr._bytes_per_device(pshapes, specs, mesh)
                    row["model_flops"] = 2.0 * n_active * tokens
                if shape.kind == "decode":
                    cache = input_specs(cfg, shape)["cache"]
                    cspecs = cache_specs(cfg, cache, mesh, shape.global_batch)
                    row["arg_bytes"] += dr._bytes_per_device(
                        jax.tree.leaves(cache),
                        jax.tree.leaves(cspecs, is_leaf=lambda s: isinstance(s, P)), mesh)
                    row["model_flops"] = 2.0 * n_active * shape.global_batch
                    row["cache_specs"] = {p: spec_list(sp) for p, sp in cache_items(cspecs)}
                out[f"{arch}|{shape_name}|{mesh_name}"] = row
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
