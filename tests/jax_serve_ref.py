"""JAX's jitted sharded prefill and decode_step on 4 fake CPU devices, for
the cases of tests/torch_serve_ranks.py, in a process of its own (the
device count must be set before jax is imported):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python -c "import jax_serve_ref as r; r.main(IN_NPZ, OUT_NPZ)"   # tests/ on sys.path

IN_NPZ is the ranks' inputs.npz (JAX's init params of each arch, each
case's prompt, frames and decode tokens). Each case runs as the JAX dry
run lowers the serving shapes (src/repro/launch/dryrun.py): ``jax.jit``
of ``prefill`` with in_shardings (param_shardings(mode="serve"), the
batch by train_batch_pspec, the frames by its batch entry), then of
``decode_step`` with (the same params, the token replicated, the dry
run's cache shardings: tests/jax_dryrun_ref.py's ``cache_specs``), on
``jax.make_mesh`` of the case's layout. OUT_NPZ gets, per case, the
logits of the prefill and of each tick and every cache leaf after the
prefill and after the last tick, whole, under the paths of
``repro_torch.models.sharding.cache_items``. Not collected by pytest (no
test_ prefix).
"""
import sys

import jax_dryrun_ref
import torch_serve_ranks as ranks


def main(in_path, out_path):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.models.transformer as tf
    from repro.configs import get_config
    from repro.models.sharding import param_shardings, train_batch_pspec

    assert jax.device_count() == ranks.WORLD, jax.devices()
    inputs = np.load(in_path)
    out = {}
    for case, arch, lay, B in ranks.CASES:
        cfg = ranks.case_config(get_config(arch), arch)
        shape, names = ranks.LAYOUTS[lay]
        # GSPMD's automatic axes: the installed jax's default (explicit)
        # axes refuse the decode cache's scatter update (ROADMAP RC7)
        mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
        pre = f"{arch}/params/"
        params = ranks.nested({k[len(pre):]: jnp.asarray(inputs[k]) for k in inputs.files
                               if k.startswith(pre)})
        pshard = param_shardings(cfg, tf.param_shapes(cfg), mesh, mode="serve")
        bspec = train_batch_pspec(mesh, B)
        bshard = {"tokens": NamedSharding(mesh, bspec)}
        batch = {"tokens": jnp.asarray(inputs[f"{case}/tokens"])}
        if cfg.is_encoder_decoder:
            bshard["frames"] = NamedSharding(mesh, P(bspec[0], None, None))
            batch["frames"] = jnp.asarray(inputs[f"{case}/frames"])

        def prefill_step(params, batch):
            return tf.prefill(cfg, params, batch["tokens"], batch.get("frames"),
                              extra_len=ranks.EXTRA)

        def decode_step(params, token, cache):
            return tf.decode_step(cfg, params, token, cache)

        with jax.set_mesh(mesh):
            logits, cache = jax.jit(prefill_step, in_shardings=(pshard, bshard))(params, batch)
            key = case.replace("|", "_")
            out[f"{key}/prefill/logits"] = np.asarray(logits)
            out.update({f"{key}/prefill/{p}": np.asarray(t)
                        for p, t in jax_dryrun_ref.cache_items(cache)})
            specs = jax_dryrun_ref.cache_specs(cfg, cache, mesh, B)
            cshard = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                  is_leaf=lambda s: isinstance(s, P))
            step = jax.jit(decode_step, in_shardings=(pshard, NamedSharding(mesh, P()), cshard))
            steps = inputs[f"{case}/steps"]
            for i in range(ranks.STEPS):
                # the step's outputs keep the shardings GSPMD chose: laid
                # out again as the dry run's specs say before each tick
                cache = jax.device_put(cache, cshard)
                logits, cache = step(params, jnp.asarray(steps[i]), cache)
                out[f"{key}/decode{i}/logits"] = np.asarray(logits)
            out.update({f"{key}/decode/{p}": np.asarray(t)
                        for p, t in jax_dryrun_ref.cache_items(cache)})
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
