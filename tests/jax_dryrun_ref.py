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
``active_param_count``. Not collected by pytest (no test_ prefix).
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


def main(out_path):
    import jax
    from jax.sharding import PartitionSpec as P

    import repro.launch.dryrun as dr
    import repro.models.transformer as tf
    from repro.configs import ARCH_IDS, get_config
    from repro.launch.input_specs import INPUT_SHAPES, input_specs, shape_applicable
    from repro.models.sharding import param_pspecs

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
                out[f"{arch}|{shape_name}|{mesh_name}"] = row
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
