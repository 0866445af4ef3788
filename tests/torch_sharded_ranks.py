"""The port's sharded LM train step in one 4-rank gloo world on the CPU.

    python -c "import torch_sharded_ranks as r; r.main(OUT_DIR)"   # tests/ on sys.path

OUT_DIR/inputs.npz holds, for each arch of STEP_CASES, the init params of
its reduced config ("<arch>/params/<path>") and its batches
("<arch>/b<B>/<key>"), written by tests/test_torch_train_sharded.py. main
spawns four ranks (a FileStore under OUT_DIR: no ports) that run every
multi-rank scenario in turn: the mesh makers, the differentiable gathers
and the reduce-scatter, shard/gather round trips, two steps of
make_sharded_train_step per case (serve or train mode, microbatches,
ZeRO-2), one train-mode step under remat with its saved tensors recorded,
and the counts of one step split over model 4. Each rank writes
rank<r>.json; rank 0 also writes each case's gathered params and both
moments to <case>.npz. The ranks import only the port and numpy; the test
compares their results with the JAX package in its own process. Not
collected by pytest (no test_ prefix).
"""
import dataclasses
import datetime
import gc
import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SEQ = 24
STEPS = 2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LAYOUTS = {
    "data4": ((4, 1), ("data", "model")),
    "data2_model2": ((2, 2), ("data", "model")),
    "pod2_data2": ((2, 2, 1), ("pod", "data", "model")),
    "model4": ((1, 4), ("data", "model")),
}
STEP_ARCHS = ("gemma3-1b", "qwen3-moe-30b-a3b", "mamba2-780m")
SERVE = {"mode": "serve", "microbatches": 1, "zero2": False}
TRAIN = {"mode": "train", "microbatches": 1, "zero2": False}
TRAIN_M2 = {"mode": "train", "microbatches": 2, "zero2": False}
ZERO2 = {"mode": "train", "microbatches": 2, "zero2": True}
# (case, arch, layout, global batch, step options); batch 2 on data 4
# splits the sequence. ZeRO-2 takes JAX's dry-run specs: serve inside,
# train for the gradients
STEP_CASES = [(f"{a}|{lay}|{b}", a, lay, b, SERVE) for a in STEP_ARCHS
              for lay, b in (("data4", 8), ("data2_model2", 8), ("pod2_data2", 8), ("data4", 2))]
STEP_CASES.append(("whisper-tiny|data2_model2|8", "whisper-tiny", "data2_model2", 8, SERVE))
STEP_CASES += [(f"{a}|model4|8", a, "model4", 8, SERVE) for a in STEP_ARCHS]
STEP_CASES += [(f"{a}|{lay}|8|train", a, lay, 8, TRAIN) for a in STEP_ARCHS
               for lay in ("model4", "data2_model2", "pod2_data2")]
STEP_CASES += [(f"{a}|data2_model2|8|train|m2", a, "data2_model2", 8, TRAIN_M2)
               for a in STEP_ARCHS]
STEP_CASES += [(f"{a}|{lay}|8|train|m2|zero2", a, lay, 8, ZERO2) for a in STEP_ARCHS
               for lay in ("pod2_data2", "data2_model2", "model4")]
STEP_CASES += [(f"{a}|data2_model2|8|train", a, "data2_model2", 8, TRAIN)
               for a in ("whisper-tiny", "zamba2-2_7b")]
ROUNDTRIP_ARCHS = ("gemma3-1b", "qwen3-moe-30b-a3b")
# the per-rank counts of one serve-mode step split over model 4
COUNT_ARCHS = ("gemma3-1b", "qwen3-moe-30b-a3b", "mamba2-780m")


def reduced(arch, **changes):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), **changes)


def flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def nested(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def load_params(inputs, arch):
    pre = f"{arch}/params/"
    return nested({k[len(pre):]: torch.from_numpy(inputs[k]) for k in inputs.files
                   if k.startswith(pre)})


def load_batch(inputs, arch, B):
    pre = f"{arch}/b{B}/"
    return {k[len(pre):]: torch.from_numpy(inputs[k]) for k in inputs.files if k.startswith(pre)}


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def nbytes(tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def make_meshes():
    from repro_torch.core import make_mesh

    return {name: make_mesh(shape, names, device="cpu") for name, (shape, names) in LAYOUTS.items()}


def mesh_makers(meshes):
    from repro_torch.core import make_mesh
    from repro_torch.launch import make_host_mesh, make_production_mesh

    host = make_host_mesh(2, 2, device="cpu")
    ref = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"host_shape": host.shape, "host_distributed": host.distributed,
           "host_coords": [host.coord(a) for a in ("data", "model")],
           "ref_coords": [ref.coord(a) for a in ("data", "model")],
           "host_groups": [dist.get_process_group_ranks(host.group(a)) for a in ("data", "model")],
           "ref_groups": [dist.get_process_group_ranks(ref.group(a)) for a in ("data", "model")]}
    for key, kw in (("production", {}), ("production_multi", {"multi_pod": True})):
        try:
            make_production_mesh(device="cpu", **kw)
            out[key] = None
        except RuntimeError as e:
            out[key] = str(e)
    return out


def gather_backward(mesh):
    """AllGather over 'data' of a (2, 3) block: the gradient of
    sum(w * full) with w = (data coord + 1) everywhere is this rank's block
    of it, as it is; AllGatherSum's is the sum over the axis of it; the
    reduce-scatter of the same weights along dim 0 sums over the axis and
    keeps this rank's block, as psum then the block does, along dim 1 too,
    one reduce_scatter call each; all_gather_dim along dim 1."""
    from repro_torch.core import distributed as dist_mod

    out = {}
    c = mesh.coord("data")
    t = torch.full((2, 3), float(dist.get_rank()), requires_grad=True)
    full = dist_mod.all_gather_grad(t, mesh, "data", 0)
    (full * (c + 1.0)).sum().backward()
    out["gather"] = {"full": full.detach().tolist(), "grad": t.grad.tolist()}
    t = torch.full((2, 3), float(dist.get_rank()), requires_grad=True)
    (dist_mod.all_gather_grad(t, mesh, "data", 0, sum_grad=True) * (c + 1.0)).sum().backward()
    out["gather_sum_grad"] = t.grad.tolist()
    w = torch.arange(12.0).view(4, 3) * (c + 1.0)
    dist_mod.reset_collective_counts()
    out["psum_scatter"] = dist_mod.psum_scatter(w, mesh, "data", 0).tolist()
    w1 = torch.arange(24.0).view(3, 8) * (c + 1.0) + dist.get_rank()
    out["psum_scatter_dim1"] = dist_mod.psum_scatter(w1, mesh, "data", 1).tolist()
    out["psum_then_block_dim1"] = dist_mod.block_of(
        dist_mod.psum(w1, mesh, "data"), mesh, "data", 1).tolist()
    out["scatter_calls"] = dict(dist_mod.COLLECTIVES)
    # along dim 1 as well
    t = torch.arange(6.0).view(2, 3) + 10 * c
    out["dim1"] = dist_mod.all_gather_dim(t, mesh, "data", 1).tolist()
    return out


def round_trips(meshes):
    from repro_torch.models import init_params
    from repro_torch.models import sharding
    from repro_torch.models.transformer import param_shapes

    out = {}
    for arch in ROUNDTRIP_ARCHS:
        cfg = reduced(arch)
        full = init_params(cfg, 0, "cpu")
        shapes = param_shapes(cfg)
        for lay, mesh in meshes.items():
            for mode in ("serve", "train"):
                sh = sharding.param_shardings(cfg, shapes, mesh, mode)
                blocks = sharding.shard_tree(sh, full)
                back = sharding.gather_tree(sh, blocks)
                leaves = sharding.tree_leaves(full)
                out[f"{arch}|{lay}|{mode}"] = {
                    "equal": all(torch.equal(a, b) for a, b in
                                 zip(leaves, sharding.tree_leaves(back))),
                    "held": nbytes(sharding.tree_leaves(blocks)),
                    "full": nbytes(leaves),
                    "sharded_leaves": sum(bool(sharding.spec_axes(s.spec))
                                          for s in sharding.tree_leaves(sh)),
                }
    return out


def step_options(cfg, mesh, options):
    """make_sharded_train_step's keyword arguments for a case's options."""
    from repro_torch.models import sharding
    from repro_torch.models.transformer import param_shapes

    kw = {"mode": options["mode"], "microbatches": options["microbatches"]}
    if options["zero2"]:
        shapes = param_shapes(cfg)
        kw["inner_param_specs"] = sharding.param_pspecs(cfg, shapes, mesh, "serve")
        kw["grad_specs"] = sharding.param_pspecs(cfg, shapes, mesh, "train")
    return kw


def step_case(case, arch, mesh, B, options, inputs, out_dir):
    from repro_torch.models import loss_fn, sharding
    from repro_torch.train import AdamW
    from repro_torch.train.loop import make_sharded_train_step

    cfg = reduced(arch)
    full = load_params(inputs, arch)
    batch = load_batch(inputs, arch, B)
    opt = AdamW(**OPT)
    step, pshard, opt_shard, batch_shard = make_sharded_train_step(
        cfg, opt, mesh, B, SEQ, **step_options(cfg, mesh, options))
    params = sharding.shard_tree(pshard, full)
    state = opt.init(params)
    local = {k: batch_shard[k].shard(v) for k, v in batch.items()}
    res = {"bspec": list(batch_shard["tokens"].spec), "metrics": []}
    if arch.startswith("qwen3-moe"):
        # this rank's rows alone through the unsharded loss: its own E sum f p
        with torch.no_grad():
            res["local_aux"] = float(loss_fn(cfg, full, local)[1]["aux_loss"])
    for _ in range(STEPS):
        params, state, m = step(params, state, local)
        res["metrics"].append({k: float(v) for k, v in m.items()})
    p_leaves = sharding.tree_leaves(params)
    res["held"] = {"params": nbytes(p_leaves), "mu": nbytes(sharding.tree_leaves(state.mu)),
                   "nu": nbytes(sharding.tree_leaves(state.nu))}
    res["model_sharded"] = [p for p, s in flat_paths(pshard)
                            if "model" in sharding.spec_axes(s.spec) and mesh.shape["model"] > 1]
    gathered = sharding.gather_tree(pshard, params)
    mu = sharding.gather_tree(pshard, state.mu)
    nu = sharding.gather_tree(pshard, state.nu)
    res["digest"] = digest(sharding.tree_leaves(gathered))
    res["step"] = int(state.step)
    if dist.get_rank() == 0:
        arrays = {f"params/{p}": t.numpy() for p, t in flat_paths(gathered)}
        arrays.update({f"mu/{p}": t.numpy() for p, t in flat_paths(mu)})
        arrays.update({f"nu/{p}": t.numpy() for p, t in flat_paths(nu)})
        np.savez(os.path.join(out_dir, case.replace("|", "_") + ".npz"), **arrays)
    return res


def remat_probe(mesh, inputs, remat):
    """One train-mode step of reduced gemma3 (remat on or off) on ``mesh``:
    the shapes saved outside the checkpointed bodies, the layer leaves
    gathered over the batch axes (their model blocks) still alive when the
    backward starts, and the collectives of the step."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.models import sharding
    from repro_torch.train import AdamW
    from repro_torch.train.loop import make_sharded_train_step

    cfg = reduced("gemma3-1b", remat=remat)
    full = load_params(inputs, "gemma3-1b")
    batch = load_batch(inputs, "gemma3-1b", 8)
    opt = AdamW(**OPT)
    step, pshard, _, bshard = make_sharded_train_step(cfg, opt, mesh, 8, SEQ, mode="train")
    params = sharding.shard_tree(pshard, full)
    state = opt.init(params)
    local = {k: bshard[k].shard(v) for k, v in batch.items()}
    layer_specs = dict(flat_paths(pshard["layers"]))
    layer_full = dict(flat_paths(full["layers"]))
    batch_ax = sharding.batch_axes(mesh)
    sharded_layer = [p for p, s in layer_specs.items()
                     if set(sharding.spec_axes(s.spec[1:])) & set(batch_ax)]
    msz = mesh.shape["model"]

    def model_block(p):  # the shape a body gathers: the leaf's model block
        return tuple(n // msz if "model" in sharding.entry_axes(e) else n for n, e in
                     zip(layer_full[p].shape[1:], tuple(layer_specs[p].spec[1:])))

    # the matrices among them: what autograd would save (a norm's scale is
    # read into a fresh tensor)
    matrices = [p for p in sharded_layer if len(model_block(p)) >= 2]
    slice_shapes = {model_block(p) for p in matrices}
    top_sharded = [k for k, s in pshard.items()
                   if not isinstance(s, dict) and sharding.spec_axes(s.spec)]

    # weak refs to the gathered layer matrices' storages (a view, as a
    # slice of a replicated wk is, keeps the storage and not the tensor)
    gathered = []
    real_gather = dist_mod.all_gather_dim
    expired = torch.UntypedStorage._expired

    def recording_gather(t, m, name, dim):
        g = real_gather(t, m, name, dim)
        if tuple(g.shape) in slice_shapes:
            st = g.untyped_storage()
            gathered.append((st._weak_ref(), st.data_ptr()))
        return g

    saved = []

    def pack(t):  # the shapes of saved tensors on a live gathered storage
        ptr = t.untyped_storage().data_ptr()
        if any(p == ptr and not expired(r) for r, p in gathered):
            saved.append(tuple(t.shape))
        return t

    alive = []
    real_grad = torch.autograd.grad

    def grad_after_forward(*a, **kw):
        gc.collect()
        alive.append(sum(not expired(r) for r, _ in gathered))
        return real_grad(*a, **kw)

    dist_mod.reset_collective_counts()
    dist_mod.all_gather_dim = recording_gather
    torch.autograd.grad = grad_after_forward
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            step(params, state, local)
    finally:
        dist_mod.all_gather_dim = real_gather
        torch.autograd.grad = real_grad
    for r, _ in gathered:
        torch.UntypedStorage._free_weak_ref(r)
    return {
        "layers": cfg.n_layers,
        "sharded_layer_leaves": sharded_layer,
        "matrix_leaves": matrices,
        "top_sharded": top_sharded,
        "slice_shapes": sorted(slice_shapes),
        "saved_slice_shapes": sorted({s for s in saved if s in slice_shapes}),
        "gathered": len(gathered),
        "alive_at_backward": alive[0],
        "collectives": dict(dist_mod.COLLECTIVES),
    }


def split_counts(mesh, inputs):
    """The counts of one serve-mode step of each COUNT_ARCHS arch at this
    rank of ``mesh`` (model 4): its FLOPs, and its kernel launches."""
    from repro_torch.models import sharding
    from repro_torch.roofline.analysis import CostCounter
    from repro_torch.train import AdamW
    from repro_torch.train.loop import make_sharded_train_step

    out = {}
    for arch in COUNT_ARCHS:
        cfg = reduced(arch)
        opt = AdamW(**OPT)
        step, pshard, _, bshard = make_sharded_train_step(cfg, opt, mesh, 8, SEQ)
        params = sharding.shard_tree(pshard, load_params(inputs, arch))
        state = opt.init(params)
        local = {k: bshard[k].shard(v) for k, v in load_batch(inputs, arch, 8).items()}
        with CostCounter() as c:
            step(params, state, local)
        out[arch] = {"flops": c.costs.flops, "kernels": dict(c.costs.kernels)}
    return out


def scenarios(out_dir):
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    meshes = make_meshes()
    out = {"coords": {k: {a: m.coord(a) for a in m.shape} for k, m in meshes.items()},
           "makers": mesh_makers(meshes),
           "gather_backward": gather_backward(meshes["data2_model2"]),
           "round_trips": round_trips(meshes), "steps": {}}
    for case, arch, lay, B, options in STEP_CASES:
        out["steps"][case] = step_case(case, arch, meshes[lay], B, options, inputs, out_dir)
    out["remat"] = {str(r): remat_probe(meshes["data2_model2"], inputs, r) for r in (True, False)}
    out["split_counts"] = split_counts(meshes["model4"], inputs)
    return out


def rank_main(rank, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120),
    )
    try:
        out = scenarios(out_dir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(out_dir):
    mp.start_processes(rank_main, args=(out_dir,), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])
