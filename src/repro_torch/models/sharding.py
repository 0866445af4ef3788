"""Partition specs for params, optimizer state, inputs and caches: the JAX
package's ``models/sharding.py`` over the port's ``core.distributed.Mesh``.

The specs are the JAX package's, leaf for leaf:
  * Megatron-style tensor parallelism over the 'model' axis: attention q
    heads / kv heads (when divisible) / wo input heads, the MLP hidden dim,
    the MoE expert dim, SSM heads and inner dim, and the vocab dim of
    lm_head;
  * data parallelism over 'data' (and 'pod' when present) on the batch
    dim; ``mode="train"`` adds FSDP over those axes (``_apply_fsdp``);
  * decode caches shard the batch over the data axes when it divides,
    else the sequence (context parallelism, the B = 1 case).

A spec is a ``P``: one entry per leading dim, each None (replicated), an
axis name, or a tuple of names (the dim split over their product, the
first the major). It compares equal to ``tuple(jax.sharding.PartitionSpec(
...))``. ``NamedSharding`` binds a spec to a mesh and adds the two
operations the sharded train step needs, both from the spec and the rank's
``mesh.coord``: ``shard`` (this rank's block of a full tensor) and
``gather`` (the full tensor from the blocks). ``StepSharding`` is what the
step hands the model: it gathers each layer's leaves over the batch axes
(FSDP) where the layer uses them, under autograd, and sums over the batch
axes; ``ModelSplit`` splits the compute over ``model`` as the specs split
the leaves.

Specs need only ``mesh.shape`` (a dict of axis sizes); shard and gather
need a ``core.distributed.Mesh``. A spec that names an axis the mesh
lacks, or splits a dim its axes do not divide, raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core import distributed as dist_mod

Tensor = torch.Tensor

MODEL_AXIS = "model"


def _entry(e):
    """An entry in JAX's canonical form: a list as a tuple, a one-name
    tuple as the name, an empty tuple as None."""
    if isinstance(e, list):
        e = tuple(e)
    if isinstance(e, tuple):
        if not e:
            return None
        if len(e) == 1:
            return e[0]
    return e


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): dims past its
    length are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis a spec names, in its order."""
    return tuple(a for e in spec for a in entry_axes(e))


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _model_size(mesh) -> int:
    return mesh.shape.get(MODEL_AXIS, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _apply_fsdp(spec: P, leaf, mesh, fsdp_axes: Tuple[str, ...], name: str = "") -> P:
    """ZeRO/FSDP: additionally shard the largest un-sharded dim of every
    >=2D parameter over the data(+pod) axes, if divisible, so params and
    optimizer moments scale with the full device count.

    The token embedding is special-cased as in the JAX package: the fsdp
    axes stack onto its d_model dim, not the vocab dim. The leading
    stacked-layer dim of a >2D leaf is never chosen."""
    shape = tuple(leaf.shape)
    if not fsdp_axes or len(shape) < 2:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if name == "embed":
        cur = entry_axes(entries[-1])
        total = math.prod(mesh.shape[a] for a in cur + fsdp_axes)
        if shape[-1] % total == 0:
            entries[-1] = tuple(cur) + tuple(fsdp_axes)
            return P(*entries)
        return spec
    fsdp_size = math.prod(mesh.shape[a] for a in fsdp_axes)
    cand = [
        (shape[i], i)
        for i in range(1 if len(shape) > 2 else 0, len(shape))
        if entries[i] is None and shape[i] % fsdp_size == 0
    ]
    if not cand:
        return spec
    _, dim = max(cand)
    entries[dim] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return P(*entries)


def _spec_for(path: str, leaf, cfg: ModelConfig, msz: int) -> P:
    """Partition spec for one parameter leaf (``path`` is '/'-joined key
    names). Stacked layer leaves have a leading L dim: None is prepended
    for each dim in front of the unstacked shape."""
    shape = tuple(leaf.shape)
    nd = len(shape)
    name = path.split("/")[-1]
    M = MODEL_AXIS

    def spec(*tail):
        return P(*((None,) * (nd - len(tail)) + tail))

    # ---- embeddings / head
    if name == "embed":
        return spec(None, M) if _div(cfg.d_model, msz) else spec(None, None)
    if name == "lm_head":
        return spec(None, M) if _div(cfg.vocab_padded, msz) else spec(None, None)
    if name in ("enc_pos", "dec_pos"):
        return spec(None, None)

    # ---- attention
    if name == "wq":
        return spec(None, M) if _div(cfg.n_heads, msz) else spec(None, None)
    if name in ("wk", "wv"):
        return spec(None, M) if _div(cfg.n_kv_heads, msz) else spec(None, None)
    if name == "wo":
        return spec(M, None) if _div(cfg.n_heads, msz) else spec(None, None)
    if name == "bq":
        return spec(M) if _div(cfg.n_heads, msz) else spec(None)
    if name in ("bk", "bv"):
        return spec(M) if _div(cfg.n_kv_heads, msz) else spec(None)
    if name in ("q_norm", "k_norm"):
        return spec(None)

    # ---- dense MLP
    if name in ("w_gate", "w_up") and "moe" not in path:
        return spec(None, M) if _div(cfg.d_ff, msz) else spec(None, None)
    if name == "w_down" and "moe" not in path:
        return spec(M, None) if _div(cfg.d_ff, msz) else spec(None, None)

    # ---- MoE
    if "moe" in path:
        if name == "router":
            return spec(None, None)
        if name in ("w_gate", "w_up", "w_down"):
            return spec(M, None, None) if _div(cfg.n_experts, msz) else spec(None, None, None)
        fs = cfg.d_ff * max(cfg.n_shared_experts, 1)
        if name in ("shared_gate", "shared_up"):
            return spec(None, M) if _div(fs, msz) else spec(None, None)
        if name == "shared_down":
            return spec(M, None) if _div(fs, msz) else spec(None, None)

    # ---- SSM
    if name in ("w_z", "w_x", "w_dt"):
        return spec(None, M) if _div(cfg.ssm_heads, msz) else spec(None, None)
    if name in ("w_B", "w_C"):
        return spec(None, None)  # g*n small; replicate
    if name in ("A_log", "D", "dt_bias"):
        return spec(M) if _div(cfg.ssm_heads, msz) else spec(None)
    if name in ("conv_w", "conv_b"):
        return P(*((None,) * nd))  # small depthwise filters: replicate
    if name == "norm" and nd >= 1:
        return spec(M) if _div(cfg.ssm_heads, msz) and shape[-1] == cfg.d_inner else spec(None)
    if name == "out_proj":
        return spec(M, None) if _div(cfg.ssm_heads, msz) else spec(None, None)

    # ---- norms / defaults
    return P(*((None,) * nd))


# ---------------------------------------------------------------------------
# trees: nested dicts (the model's param tree) whose leaves are tensors,
# shape records, specs or shardings (a spec is a tuple, yet a leaf)
# ---------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (``tree`` may hold a subset of their keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# param specs
# ---------------------------------------------------------------------------
def param_pspecs(cfg: ModelConfig, params_shape: Any, mesh, mode: str = "serve") -> Any:
    """The spec tree of ``params_shape`` (any tree of leaves with a
    ``.shape``, e.g. ``transformer.param_shapes(cfg)``).

    mode='serve': tensor-parallel over 'model' only. mode='train':
    additionally FSDP over the data(+pod) axes, so params and AdamW moments
    scale with the full device count."""
    if mode not in ("serve", "train"):
        raise ValueError(f"mode must be 'serve' or 'train', got {mode!r}")
    msz = _model_size(mesh)
    fsdp = batch_axes(mesh) if mode == "train" else ()
    paths = dict(_with_paths(params_shape))
    specs = {}
    for path, leaf in paths.items():
        s = _spec_for(path, leaf, cfg, msz)
        specs[path] = _apply_fsdp(s, leaf, mesh, fsdp, name=path.split("/")[-1])

    def build(node, prefix=""):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in node.items()}
        return specs[prefix]

    return build(params_shape)


class NamedSharding:
    """A spec bound to a mesh (``jax.sharding.NamedSharding``), with this
    rank's ``shard`` of a full tensor and the ``gather`` of the blocks."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)
        seen = set()
        for a in spec_axes(self.spec):
            if a not in mesh.shape:
                raise ValueError(f"spec {self.spec} names axis {a!r}, which the mesh "
                                 f"{dict(mesh.shape)} lacks")
            if a in seen:
                raise ValueError(f"spec {self.spec} names axis {a!r} twice")
            seen.add(a)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec})"

    def _parts(self, dim: int) -> int:
        return math.prod(self.mesh.shape[a] for a in entry_axes(self.spec[dim]))

    def check(self, shape) -> None:
        """Raise unless every sharded dim of ``shape`` splits evenly."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {shape} has dims")
        for dim in range(len(self.spec)):
            k = self._parts(dim)
            if shape[dim] % k:
                raise ValueError(f"dim {dim} of shape {shape} does not split over "
                                 f"{entry_axes(self.spec[dim])} ({k} blocks): spec {self.spec}")

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one rank's block of a tensor of ``shape``."""
        self.check(shape)
        shape = tuple(shape)
        return tuple(n // self._parts(i) if i < len(self.spec) else n
                     for i, n in enumerate(shape))

    def block_index(self, dim: int) -> int:
        """This rank's block along ``dim``: its coords over the entry's
        axes, the first the major."""
        idx = 0
        for a in entry_axes(self.spec[dim]):
            idx = idx * self.mesh.shape[a] + self.mesh.coord(a)
        return idx

    def shard(self, t: Tensor) -> Tensor:
        """This rank's block of the full tensor ``t``, as a new contiguous
        tensor (updates to it never reach ``t``)."""
        self.check(t.shape)
        out = t
        for dim in range(len(self.spec)):
            k = self._parts(dim)
            if k > 1:
                n = t.shape[dim] // k
                out = out.narrow(dim, self.block_index(dim) * n, n)
        return out.clone(memory_format=torch.contiguous_format)

    def _require_groups(self) -> None:
        for a in spec_axes(self.spec):
            if self.mesh.shape[a] > 1 and self.mesh.group(a) is None:
                raise RuntimeError(f"axis {a!r} of size {self.mesh.shape[a]} has no process "
                                   f"group: {self.mesh!r} cannot gather {self.spec}")

    def gather(self, t: Tensor) -> Tensor:
        """The full tensor from every rank's block ``t`` (one all_gather per
        axis of each sharded dim, the minor axis first); not differentiable."""
        self._require_groups()
        for dim in range(len(self.spec)):
            for a in reversed(entry_axes(self.spec[dim])):
                t = dist_mod.all_gather_dim(t, self.mesh, a, dim)
        return t

    def gather_grad(self, t: Tensor, lead: int = 0, axes=None, summed=()) -> Tensor:
        """``gather`` under autograd for a block ``t`` whose spec is this
        one without its first ``lead`` entries (one layer of a stacked
        leaf: ``lead`` = 1), over ``axes`` only when given (the others'
        blocks stay; the caller gathers the lead dims, as
        ``StepSharding.gather_layers`` does). The backward of an axis in
        ``summed`` sums the gradient over the axis and keeps this rank's
        block (the positions along it computed different rows); of any
        other axis it keeps this rank's block of the gradient as it is
        (every position computed it alike)."""
        self._require_groups()
        if axes is None and spec_axes(self.spec[:lead]):
            raise ValueError(f"spec {self.spec} shards the stacked layer dim: a layer's "
                             "block is not a layer")
        for i, entry in enumerate(self.spec[lead:]):
            for a in reversed(entry_axes(entry)):
                if axes is None or a in axes:
                    t = dist_mod.all_gather_grad(t, self.mesh, a, i, sum_grad=a in summed)
        return t


def param_shardings(cfg: ModelConfig, params_shape: Any, mesh, mode: str = "serve") -> Any:
    """The ``NamedSharding`` tree of ``param_pspecs``, each checked against
    its leaf's shape."""
    specs = param_pspecs(cfg, params_shape, mesh, mode)

    def bind(leaf, spec):
        s = NamedSharding(mesh, spec)
        s.check(leaf.shape)
        return s

    return tree_map(bind, params_shape, specs)


def shard_tree(shardings, tree):
    """This rank's blocks of a tree of full tensors."""
    return tree_map(lambda t, s: s.shard(t), tree, shardings)


def gather_tree(shardings, tree):
    """The full tensors of a tree of this rank's blocks."""
    return tree_map(lambda t, s: s.gather(t), tree, shardings)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------
def train_batch_pspec(mesh, global_batch: int) -> P:
    dp = batch_axes(mesh)
    dsz = math.prod(mesh.shape[a] for a in dp)
    if _div(global_batch, dsz):
        return P(dp, None)
    return P(None, dp)  # batch too small: shard the sequence instead


def decode_cache_pspec(cfg: ModelConfig, mesh, batch: int, kind: str) -> Any:
    """Spec dict for one layer's cache. kind: 'attn'|'local'|'ssm'."""
    dp = batch_axes(mesh)
    msz = _model_size(mesh)
    dsz = math.prod(mesh.shape[a] for a in dp)
    b_ax = dp if _div(batch, dsz) else None
    s_ax = dp if not _div(batch, dsz) else None  # context parallelism (B=1)
    if kind == "ssm":
        h_ax = MODEL_AXIS if _div(cfg.ssm_heads, msz) else None
        return {"state": P(b_ax, h_ax, None, None), "conv": P(b_ax, None, None)}
    kv_ax = MODEL_AXIS if _div(cfg.n_kv_heads, msz) else None
    hd_ax = MODEL_AXIS if (kv_ax is None and _div(cfg.head_dim, msz)) else None
    return {"k": P(b_ax, s_ax, kv_ax, hd_ax), "v": P(b_ax, s_ax, kv_ax, hd_ax),
            "pos": P(b_ax, s_ax)}


def _cache_map(fn, cache, *rest):
    """``fn`` over the leaves of a ``transformer.DecodeCache`` (a stacked
    dict or a list of per-layer dicts, the position, the shared-block and
    cross caches) and the matching leaves of ``rest``."""
    def layers(node, *r):
        if isinstance(node, dict):
            return {k: fn(v, *(x[k] for x in r)) for k, v in node.items()}
        return [layers(n, *(x[i] for x in r)) for i, n in enumerate(node)]

    shared = (None if cache.shared is None else
              [layers(c, *(x.shared[i] for x in rest)) for i, c in enumerate(cache.shared)])
    cross = (None if cache.cross is None else
             [tuple(fn(t, *(x.cross[i][j] for x in rest)) for j, t in enumerate(kv))
              for i, kv in enumerate(cache.cross)])
    return dataclasses.replace(cache, layers=layers(cache.layers, *(x.layers for x in rest)),
                               position=fn(cache.position, *(x.position for x in rest)),
                               shared=shared, cross=cross)


def cache_items(cache, prefix: str = ""):
    """(path, leaf) of every leaf of a ``DecodeCache``, in a fixed order:
    ``layers/<i or key>/<key>``, ``position``, ``shared/<i>/<key>``,
    ``cross/<i>/<0 or 1>``."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
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


def decode_cache_shardings(cfg: ModelConfig, mesh, batch: int, cache):
    """The ``NamedSharding`` of every leaf of ``cache`` (a
    ``transformer.DecodeCache`` of any tensors, e.g. meta ones, giving the
    structure), as a ``DecodeCache`` of shardings: the JAX dry run's
    ``cache_shardings`` leaf for leaf (``src/repro/launch/dryrun.py``).
    Each layer's leaves take ``decode_cache_pspec`` of its kind; a stacked
    cache's leading layer axis is replicated; the position is replicated;
    the shared block's caches are global attention's; the cross k/v are
    split like the batch (``train_batch_pspec``'s first entry). ``mesh``
    needs only ``.shape`` (the dry run's shape-only mesh) unless the
    shardings shard or gather."""
    def bind(spec):
        return NamedSharding(mesh, spec)

    def kind_of(k):
        return "ssm" if k == "ssm" else ("local" if k == "local" else "attn")

    if isinstance(cache.layers, dict):
        spec = decode_cache_pspec(cfg, mesh, batch, "ssm" if cfg.arch_type == "ssm" else "attn")
        layers: Any = {k: bind(P(None, *spec[k])) for k in cache.layers}
    else:
        layers = []
        for layer, k in zip(cache.layers, cfg.layer_kinds()):
            spec = decode_cache_pspec(cfg, mesh, batch, kind_of(k))
            layers.append({kk: bind(spec[kk]) for kk in layer})
    shared = None
    if cache.shared is not None:
        spec = decode_cache_pspec(cfg, mesh, batch, "attn")
        shared = [{kk: bind(spec[kk]) for kk in c} for c in cache.shared]
    cross = None
    if cache.cross is not None:
        ns = bind(P(train_batch_pspec(mesh, batch)[0], None, None, None))
        cross = [(ns, ns) for _ in cache.cross]
    return dataclasses.replace(cache, layers=layers, position=bind(P()), shared=shared,
                               cross=cross)


def shard_cache(shardings, cache):
    """This rank's blocks of a ``DecodeCache`` of full tensors."""
    return _cache_map(lambda t, s: s.shard(t), cache, shardings)


def gather_cache(shardings, cache):
    """The full tensors of a ``DecodeCache`` of this rank's blocks."""
    return _cache_map(lambda t, s: s.gather(t), cache, shardings)


def logits_sharding(cfg: ModelConfig, mesh, batch: int) -> "NamedSharding":
    """Where the sharded serving step's logits (B, Vp) lie: the rows split
    like the batch (when it divides the batch axes), the vocabulary over
    ``model`` where ``lm_head``'s spec splits it. Its ``gather`` gives the
    whole logits."""
    dp = batch_axes(mesh)
    dsz = math.prod(mesh.shape[a] for a in dp)
    rows = dp if _div(batch, dsz) else None
    vocab = MODEL_AXIS if _div(cfg.vocab_padded, _model_size(mesh)) else None
    return NamedSharding(mesh, P(rows, vocab))


# ---------------------------------------------------------------------------
# the sharded train step's view, handed to the model
# ---------------------------------------------------------------------------
class StepSharding:
    """What ``train.loop.make_sharded_train_step`` hands the model
    (``models.transformer``'s ``shard=`` argument): the params'
    ``NamedSharding`` tree and ``grad_axes``, the batch axes over which the
    ranks hold different rows (empty when the batch is replicated or its
    sequence was gathered).

    ``gather`` builds a leaf's ``model`` block from this rank's block where
    the model uses it: it gathers the batch axes of the leaf's spec (FSDP)
    under autograd, summing the gradient over those of ``grad_axes``
    (``core.distributed.AllGatherSum``: a reduce-scatter) and keeping this
    rank's block over the others. Nothing is gathered over ``model``: the
    model code computes on each leaf's ``model`` block (``ModelSplit``).
    ``psum_batch`` sums over ``grad_axes``."""

    # the serving step's view (``ServeSharding``) also builds decode caches
    serving = False

    def __init__(self, mesh, shardings, grad_axes: Tuple[str, ...] = ()):
        self.mesh = mesh
        self.shardings = shardings
        self.grad_axes = tuple(grad_axes)
        self.batch_positions = math.prod(mesh.shape[a] for a in self.grad_axes)
        self.split = ModelSplit(mesh)
        self._batch = batch_axes(mesh)

    def gather(self, tree, key: str, stacked: bool = True):
        """``tree``, a part of ``params[key]`` (one layer's views of a
        stacked tree when ``stacked``, else the block or leaf itself, or a
        subset of its keys), with every leaf gathered over its batch axes
        under autograd."""
        lead = 1 if stacked else 0
        return tree_map(lambda t, s: s.gather_grad(t, lead, self._batch, self.grad_axes),
                        tree, self.shardings[key])

    def gather_layers(self, tree, key: str):
        """``params[key]``, a stacked tree, with each leaf whose spec splits
        the stacked layer dim over batch axes (``_apply_fsdp`` may choose
        it for a 2-D leaf, e.g. ``A_log`` (L, H)) gathered along that dim
        under autograd, whole: one layer's block is not a layer. Such
        leaves are small (a scale or bias a layer)."""
        def one(t, s):
            for a in reversed(entry_axes(s.spec[0])):
                if a in self._batch:
                    t = dist_mod.all_gather_grad(t, self.mesh, a, 0, sum_grad=a in self.grad_axes)
            return t

        return tree_map(one, tree, self.shardings[key])

    def psum_batch(self, t: Tensor) -> Tensor:
        for a in self.grad_axes:
            t = dist_mod.psum(t, self.mesh, a)
        return t


class ServeSharding(StepSharding):
    """What the sharded serving step (``transformer.make_sharded_prefill``,
    ``make_sharded_decode_step``) hands the model: the serve-mode param
    shardings (split over ``model`` only: nothing is gathered over the
    batch axes) and no ``grad_axes``, plus the decode cache's layout for a
    global batch of ``batch`` rows, ``decode_cache_pspec``'s:

      * ``row_axes``: the batch axes that split the rows, when the batch
        divides them; each rank then runs its rows (``rows``);
      * ``seq_axes``: else (B = 1, context parallelism) the same axes split
        the cache's slots: every rank runs the whole batch, holds its block
        of each cache's slots (``seq_block``) and attends over it alone,
        the softmax combined over ``seq_axes`` (``seq_max``, ``seq_sum``);
      * ``kv_split``: the cache's kv heads split over ``model`` (a rank's
        kv heads are those its q heads read), else ``hd_split``: every kv
        head at this rank's block of ``head_dim`` (``hd_block``), whose
        scores are partial sums over ``model``;
      * ``serving``: prefill computes every kv head a replicated ``wk``
        gives (the cache holds them all), not only those its q heads read.

    On one position nothing is split and every call is the identity."""

    serving = True

    def __init__(self, mesh, shardings, cfg: ModelConfig, batch: int):
        super().__init__(mesh, shardings, ())
        dp = batch_axes(mesh)
        dsz = math.prod(mesh.shape[a] for a in dp)
        self.row_axes = dp if _div(batch, dsz) else ()
        self.seq_axes = () if self.row_axes else dp
        self.seq_parts = math.prod(mesh.shape[a] for a in self.seq_axes)
        self.seq_index = NamedSharding(mesh, P(self.seq_axes or None)).block_index(0)
        self.row_parts = math.prod(mesh.shape[a] for a in self.row_axes)
        self.row_index = NamedSharding(mesh, P(self.row_axes or None)).block_index(0)
        msz = _model_size(mesh)
        self.kv_split = msz > 1 and _div(cfg.n_kv_heads, msz)
        self.hd_split = msz > 1 and not self.kv_split and _div(cfg.head_dim, msz)

    def rows(self, t: Tensor) -> Tensor:
        """This rank's block of the rows (dim 0) of a tensor every rank
        holds whole (the replicated tokens, a per-row position)."""
        if self.row_parts == 1:
            return t
        n = t.shape[0] // self.row_parts
        return t.narrow(0, self.row_index * n, n)

    def seq_block(self, size: int) -> Tuple[int, int]:
        """(first slot, slots) of this rank's block of a cache of ``size``
        slots in all."""
        n = size // self.seq_parts
        return self.seq_index * n, n

    def hd_block(self, hd: int) -> Tuple[int, int]:
        """(first, width) of this rank's block of ``head_dim``."""
        n = hd // self.split.size if self.hd_split else hd
        return (self.split.coord * n if self.hd_split else 0), n

    def seq_max(self, t: Tensor) -> Tensor:
        for a in self.seq_axes:
            t = dist_mod.pmax(t, self.mesh, a)
        return t

    def seq_sum(self, t: Tensor) -> Tensor:
        for a in self.seq_axes:
            t = dist_mod.psum(t, self.mesh, a)
        return t


class ModelSplit:
    """The compute split over ``model`` (Megatron-style, as the specs say),
    for the model code under the sharded step: the axis's ``size`` and this
    rank's ``coord``, and the collectives that open and close a split
    block. The residual stream is replicated over ``model`` (the ranks
    there hold the same rows). A block takes the replicated tensors it
    splits its work over through ``enter`` (identity forward, the psum of
    the partial gradients backward), runs its column-parallel products on
    this rank's column block, its heads, channels or experts, its
    row-parallel product on this rank's row block, and closes with
    ``leave`` (the psum of the partial results forward). A module splits
    exactly where the spec split its leaves (the block's shape says so);
    with ``size`` 1 nothing is split and no collective is called."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.size = _model_size(mesh) if mesh is not None else 1
        self.coord = mesh.coord(MODEL_AXIS) if self.size > 1 else 0

    def enter(self, t: Tensor) -> Tensor:
        return dist_mod.copy_to(t, self.mesh, MODEL_AXIS) if self.size > 1 else t

    def leave(self, t: Tensor) -> Tensor:
        return dist_mod.reduce_from(t, self.mesh, MODEL_AXIS) if self.size > 1 else t

    def psum_both(self, t: Tensor) -> Tensor:
        """The psum of ``t`` forward and of its gradient backward: a sum that
        each rank then uses on its own block (a norm over split channels)."""
        return self.enter(self.leave(t))

    def pmax(self, t: Tensor) -> Tensor:
        return dist_mod.pmax(t, self.mesh, MODEL_AXIS) if self.size > 1 else t

    def gather(self, t: Tensor, dim: int) -> Tensor:
        """The ranks' blocks of ``t`` along ``dim``, whole; not
        differentiable (the serving step's)."""
        if self.size == 1:
            return t
        return dist_mod.all_gather_dim(t, self.mesh, MODEL_AXIS, dim)

    def gather_last(self, t: Tensor) -> Tensor:
        """The ranks' blocks of ``t`` along its last dim, whole (each rank
        then uses it alike: the backward keeps this rank's block)."""
        if self.size == 1:
            return t
        return dist_mod.all_gather_grad(t, self.mesh, MODEL_AXIS, t.dim() - 1)


NO_SPLIT = ModelSplit()


def model_split(shard: Optional[StepSharding]) -> ModelSplit:
    """The ``ModelSplit`` of the sharded step's ``shard``; without one,
    nothing is split."""
    return NO_SPLIT if shard is None else shard.split


def use(shard: Optional[StepSharding], tree, key: str, stacked: bool = True):
    """``tree`` (a part of ``params[key]``) as the model computes with it:
    gathered over the batch axes by the sharded step's ``shard``, or as it
    is without one."""
    return tree if shard is None else shard.gather(tree, key, stacked)
