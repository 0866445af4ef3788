"""The port's sharded serving step in one 4-rank gloo world on the CPU.

    python -c "import torch_serve_ranks as r; r.main(OUT_DIR)"   # tests/ on sys.path

OUT_DIR/inputs.npz holds, for each arch of ARCHS, the JAX package's init
params of its test config ("<arch>/params/<path>", written by
tests/test_torch_serve_sharded.py) and, for each case of CASES, its
prompt, frames and decode tokens ("<case>/tokens", "<case>/frames",
"<case>/steps"). main spawns four ranks (a FileStore under OUT_DIR: no
ports) that run every case in turn: make_sharded_prefill on the case's
layout, then STEPS ticks of make_sharded_decode_step on the given tokens.
Rank 0 writes, per case, the gathered logits of the prefill and of each
tick and every gathered cache leaf after the prefill and after the last
tick to <case>.npz; every rank writes the collectives of one tick by kind
and its cache blocks' shapes to rank<r>.json. tests/jax_serve_ref.py runs
the same cases through JAX's jitted sharded prefill and decode_step.
The module imports neither torch nor jax at its top, so the JAX side can
read the cases. Not collected by pytest (no test_ prefix).
"""
import dataclasses
import datetime
import json
import os
import sys

WORLD = 4
SEQ = 24  # prompt length
EXTRA = 8  # cache slots past the prompt: 32 in all, split by 2 where the batch is 1
STEPS = 3
LAYOUTS = {
    "data4": ((4, 1), ("data", "model")),
    "data2_model2": ((2, 2), ("data", "model")),
    "pod2_data2": ((2, 2, 1), ("pod", "data", "model")),
    "model4": ((1, 4), ("data", "model")),
}
# each arch's reduced config with the changes that make it hit the cases:
# gemma3 a local layer (window 16, so the prompt fills the ring and the
# ticks wrap it) and a global one, its one kv head of 64 split by head_dim
# (the cache's layout b) and its q heads split; qwen1.5 6 heads over 2 kv
# heads, which model 4 divides neither of (q, k and v replicated, the
# cache split by head_dim, as the full qwen1.5's 20 and 40 heads on 16);
# qwen3-moe, zamba2's shared block and whisper 4 kv heads (layout a);
# mamba2 and zamba2 4 SSM heads; every vocabulary split
CHANGES = {
    "gemma3-1b": dict(local_ratio=1, window=16),
    "qwen1_5-4b": dict(n_heads=6, n_kv_heads=2),
    "qwen3-moe-30b-a3b": {},
    "mamba2-780m": {},
    "zamba2-2_7b": {},
    "whisper-tiny": {},
}
ARCHS = tuple(CHANGES)
# (case, arch, layout, global batch); batch 1 splits the cache's slots over
# the batch axes (context parallelism)
CASES = [
    ("gemma3-1b|data2_model2|8", "gemma3-1b", "data2_model2", 8),
    ("gemma3-1b|model4|8", "gemma3-1b", "model4", 8),
    ("gemma3-1b|pod2_data2|8", "gemma3-1b", "pod2_data2", 8),
    ("gemma3-1b|data2_model2|1", "gemma3-1b", "data2_model2", 1),
    ("qwen1_5-4b|model4|8", "qwen1_5-4b", "model4", 8),
    ("qwen3-moe-30b-a3b|data2_model2|8", "qwen3-moe-30b-a3b", "data2_model2", 8),
    ("mamba2-780m|model4|8", "mamba2-780m", "model4", 8),
    ("mamba2-780m|data4|8", "mamba2-780m", "data4", 8),
    ("zamba2-2_7b|data2_model2|8", "zamba2-2_7b", "data2_model2", 8),
    ("zamba2-2_7b|data2_model2|1", "zamba2-2_7b", "data2_model2", 1),
    ("whisper-tiny|data2_model2|8", "whisper-tiny", "data2_model2", 8),
]


def case_config(cfg, arch):
    """``arch``'s full config of either package -> the test's config."""
    return dataclasses.replace(cfg.reduced(), **CHANGES[arch])


def tick_bytes(cfg, mesh_shape, batch, max_len, itemsize):
    """The collective bytes by kind of one decode tick at one rank (the
    all_gather's output, the all_reduce's tensor), by the formula of
    PERF.md, from the config and the layout alone: B_l rows a rank, S_l
    slots a rank, e bytes an element of the model's dtype.

    The token's embedding columns are gathered (B_l d e). Each attention
    (a layer's, a shared block's) closes ``wo`` with a psum of B_l d e
    where its q heads split; with the cache split by head_dim also gathers
    q (B_l H hd e, where q heads split) and the output blocks (B_l H hd e)
    and sums the partial scores (B_l H S_l 4); with the slots split over
    the batch axes, per axis, a pmax of B_l H' 4 and a psum of
    B_l H' (hd' + 1) 4 (H', hd' the heads and width a rank attends
    with). A split MLP, MoE block or cross-attention adds one psum of
    B_l d e; a split SSM layer a gather of its x channels (B_l d_inner
    e), the norm's psum (B_l 4) and ``out_proj``'s (B_l d e)."""
    msz = mesh_shape.get("model", 1)
    dp = [a for a in ("pod", "data") if a in mesh_shape]
    dsz = 1
    for a in dp:
        dsz *= mesh_shape[a]
    seq_axes = 0 if batch % dsz == 0 else len(dp)
    rows = batch // dsz if seq_axes == 0 else batch
    parts = dsz if seq_axes else 1
    d, e, H, KV, hd = cfg.d_model, itemsize, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = msz > 1
    out = {"all_gather": 0, "all_reduce": 0}

    def attention(slots):
        q_split = split and H % msz == 0
        kv_split = split and KV % msz == 0
        hd_split = split and not kv_split and hd % msz == 0
        heads = H if hd_split or not q_split else H // msz
        width = hd // msz if hd_split else hd
        if hd_split:
            out["all_gather"] += (rows * H * hd * e) * (2 if q_split else 1)
            out["all_reduce"] += rows * H * (slots // parts) * 4
        out["all_reduce"] += seq_axes * (rows * heads * 4 + rows * heads * (width + 1) * 4)
        if q_split:
            out["all_reduce"] += rows * d * e

    def psum_if(divisible):
        if split and divisible:
            out["all_reduce"] += rows * d * e

    if split and d % msz == 0:
        out["all_gather"] += rows * d * e
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "ssm":
            if split and cfg.ssm_heads % msz == 0:
                out["all_gather"] += rows * cfg.d_inner * e
                out["all_reduce"] += rows * 4 + rows * d * e
        else:
            local = cfg.local_ratio > 0 and kind == "local" and cfg.window
            attention(min(cfg.window, max_len) if local else max_len)
            if cfg.arch_type == "moe":
                psum_if(cfg.n_experts % msz == 0
                        or (cfg.n_shared_experts
                            and (cfg.d_ff * cfg.n_shared_experts) % msz == 0))
            else:
                psum_if(cfg.d_ff % msz == 0)
        if cfg.is_encoder_decoder:
            psum_if(H % msz == 0)
        if cfg.arch_type == "hybrid" and (i + 1) % cfg.hybrid_attn_every == 0:
            attention(max_len)
            psum_if(cfg.d_ff % msz == 0)
    return {k: v for k, v in out.items() if v}


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


def run_case(case, arch, mesh, B, inputs, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.core import distributed as dist_mod
    from repro_torch.models import make_sharded_decode_step, make_sharded_prefill, sharding

    cfg = case_config(get_config(arch), arch)
    pre = f"{arch}/params/"
    full = lm_params_from_reference(cfg, nested({k[len(pre):]: inputs[k] for k in inputs.files
                                                 if k.startswith(pre)}), device="cpu")
    batch = {"tokens": torch.from_numpy(inputs[f"{case}/tokens"])}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(inputs[f"{case}/frames"])
    steps = torch.from_numpy(inputs[f"{case}/steps"])
    prefill, pshard, bshard, cshard = make_sharded_prefill(cfg, mesh, B, SEQ, extra_len=EXTRA)
    decode, _, tshard, dshard = make_sharded_decode_step(cfg, mesh, B, SEQ + EXTRA)
    lshard = sharding.logits_sharding(cfg, mesh, B)
    params = sharding.shard_tree(pshard, full)
    logits, cache = prefill(params, {k: bshard[k].shard(v) for k, v in batch.items()})
    arrays = {"prefill/logits": lshard.gather(logits)}
    # copies: a replicated leaf gathers to itself, which the ticks update in place
    arrays.update({f"prefill/{p}": t.clone() for p, t in
                   sharding.cache_items(sharding.gather_cache(cshard, cache))})
    blocks = {p: list(t.shape) for p, t in sharding.cache_items(cache)}
    ticks = []
    for i in range(STEPS):
        dist_mod.reset_collective_counts()
        logits, cache = decode(params, tshard.shard(steps[i]), cache)
        ticks.append(dict(dist_mod.COLLECTIVE_BYTES))
        arrays[f"decode{i}/logits"] = lshard.gather(logits)
    arrays.update({f"decode/{p}": t for p, t in
                   sharding.cache_items(sharding.gather_cache(dshard, cache))})
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, case.replace("|", "_") + ".npz"),
                 **{k: v.numpy() for k, v in arrays.items()})
    return {"blocks": blocks, "tick_collective_bytes": ticks,
            "coords": {a: mesh.coord(a) for a in mesh.shape}}


def rank_main(rank, out_dir):
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120),
    )
    try:
        inputs = np.load(os.path.join(out_dir, "inputs.npz"))
        meshes = {k: make_mesh(s, n, device="cpu") for k, (s, n) in LAYOUTS.items()}
        out = {case: run_case(case, arch, meshes[lay], B, inputs, out_dir)
               for case, arch, lay, B in CASES}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main(out_dir):
    import torch.multiprocessing as mp

    mp.start_processes(rank_main, args=(out_dir,), nprocs=WORLD, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1])
