"""Distributed DMTRL — the paper's parameter-server W-step over process groups.

Mapping (the JAX package's ``core/distributed.py``):
  * ``data`` axis  = the paper's workers; tasks are sharded over it.
  * ``model`` axis = feature-dimension sharding (wide phi); the Gram
    solver sums its three d-contractions over this axis.
  * ``pod`` axis   = intra-task sample partitioning (the paper's "further
    distribute data of one task over several local workers"). Each pod owns
    a contiguous slice of every task's samples and the corresponding dual
    coordinates; delta_b is summed over pods.

A mesh is one process per position, each running the same program (SPMD)
on its own block, with explicit collectives over each axis's process group
(``Mesh``, ``make_mesh``; the JAX package writes ``shard_map`` bodies over
a ``jax.sharding.Mesh`` instead). One communication round is:

    all_gather(delta_b, 'data')            -- the worker->server "send"
    local  dW = Sigma_rows @ dB / lambda   -- the server reduce, sharded
  (+ psum over 'pod' when present, + the Gram psums over 'model')

Every rank holds its (m_loc, n_loc, d_loc) block of the data, its alpha
and W blocks and its (m_loc, m) Sigma rows. The Omega-step, the rho bound,
W(alpha) after a new Sigma and the tracked objectives are computed once, on
the root rank (index 0 on every axis), from gathered alpha and W, and
broadcast, so every rank holds bit-identical Sigma, rho and history.

Three kinds of mesh:
  * the local one-device mesh (``local_mesh``): every axis has size 1 and
    no process group, so every collective is the identity;
  * a process-group mesh over an initialised ``torch.distributed`` world
    (nccl on the card, gloo on the CPU): every collective is called, even
    over an axis of size 1;
  * the dry run's mesh (``make_mesh(..., device="meta")``, over a world of
    the ``fake`` backend): one rank of the production mesh whose tensors
    are ``meta`` tensors and whose collectives move nothing, so a traced
    step counts what a rank would compute and send.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import pickle
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import prng
from . import dual as dual_mod
from . import omega as omega_mod
from . import omega_regularizers as omega_reg
from .dmtrl import DMTRLConfig, WarmStart, _rho_value, resolve_device
from .losses import get_loss
from .mtl_data import MTLData
from .sdca import gather_rows, sample_coords, sdca_block_solve, sdca_gram_solve
from .sigma_view import LowRankDiagSigma, SigmaView, maybe_dense
from .solver_backends import get_backend

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"  # tasks
    model: Optional[str] = None  # feature dim
    pod: Optional[str] = None  # intra-task samples


@dataclasses.dataclass(frozen=True)
class DistributedOptions:
    """Mesh-engine knobs: the axis mapping and the two Gram options of a
    ``model`` axis (``dist_block_hoisted``: the block Gram per H-block
    instead of the full H x H Gram; ``gram_bf16``: X rounded to bf16 before
    the Gram products, which run in fp32)."""

    axes: MeshAxes = MeshAxes()
    dist_block_hoisted: bool = False
    gram_bf16: bool = False

    def merge_into(self, cfg: DMTRLConfig) -> DMTRLConfig:
        return dataclasses.replace(
            cfg,
            dist_block_hoisted=self.dist_block_hoisted,
            gram_bf16=self.gram_bf16,
        )


@dataclasses.dataclass
class DistributedState:
    """Padded run state. The host transports hand back whole (m, ...)
    tensors; ``fit_distributed`` hands back this rank's blocks: alpha
    (m_loc, n_loc), W (m_loc, d_loc), its (m_loc, m) Sigma/Omega rows (a
    ``LowRankDiagSigma`` of its U and d rows beside the whole core)."""

    alpha: Tensor
    W: Tensor
    # dense tensor or a SigmaView
    sigma: object
    # precision; None for structured members without a cheap inverse
    omega: Optional[object]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
class Mesh:
    """Named axes over one process per position.

    ``shape`` maps axis names to sizes, ``device`` is this rank's device,
    ``coord(name)`` its index along an axis and ``group(name)`` the axis's
    process group (None on the local one-device mesh)."""

    def __init__(self, shape: Dict[str, int], device, coords=None, groups=None,
                 device_mesh=None):
        self.shape: Dict[str, int] = dict(shape)
        self.device = torch.device(device)
        self._coords = dict(coords) if coords else {n: 0 for n in self.shape}
        self._groups = dict(groups) if groups else {}
        self.device_mesh = device_mesh

    @property
    def distributed(self) -> bool:
        """True for a mesh over process groups (its collectives are called)."""
        return bool(self._groups)

    @property
    def is_root(self) -> bool:
        return all(c == 0 for c in self._coords.values())

    def coord(self, name: Optional[str]) -> int:
        return self._coords[name] if name is not None else 0

    def group(self, name: Optional[str]):
        return self._groups.get(name) if name is not None else None

    def __repr__(self) -> str:
        kind = "process-group" if self.distributed else "local"
        return f"Mesh({self.shape}, {kind}, device={self.device}, coords={self._coords})"


def local_mesh(axes: Optional[MeshAxes] = None, device="cuda") -> Mesh:
    """The one-device mesh over the data axis (the JAX package's
    ``jax.make_mesh((1,), ("data",))``): no process group, so every
    collective is the identity."""
    axes = axes or MeshAxes()
    return Mesh({axes.data: 1}, resolve_device(device))


def make_mesh(shape, axis_names, *, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axis_names``.

    With an initialised ``torch.distributed`` default group it is a
    process-group mesh (``init_device_mesh``), whose world size must equal
    ``prod(shape)``: nccl with ``cuda:LOCAL_RANK`` on the card (LOCAL_RANK,
    else the rank modulo the card count), gloo with ``device="cpu"``.
    Without one, only a shape of one position is allowed, and that gives
    the local one-device mesh.

    ``device="meta"`` is the dry run's mesh: the default group must be of
    the ``fake`` backend (``launch.mesh.fake_world``), and this rank's
    position is its rank in the row-major order of ``shape``; each axis's
    group is built over the ranks of this rank's slice alone. No other
    device takes that backend, and the meta mesh takes no other."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} do not match")
    device = resolve_device(device)
    size = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        if size != 1:
            raise RuntimeError(
                f"a mesh of shape {shape} needs an initialised torch.distributed "
                f"default group of world size {size} (one process per position); "
                "call torch.distributed.init_process_group first"
            )
        return Mesh(dict(zip(names, shape)), device)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"mesh shape {shape} has {size} positions, the world has {world} ranks")
    backend = dist.get_backend()
    want = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}.get(device.type)
    if backend != want:
        raise ValueError(
            f"a {device.type} mesh runs over the {want} backend; the default group uses {backend!r}"
        )
    if device.type == "meta":
        return _slice_mesh(shape, names, device)
    if device.type == "cuda":
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
            device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, shape, mesh_dim_names=names)
    return Mesh(
        dict(zip(names, shape)), device,
        coords={n: dm.get_local_rank(n) for n in names},
        groups={n: dm.get_group(n) for n in names},
        device_mesh=dm,
    )


def _slice_mesh(shape, names, device) -> Mesh:
    """This rank's position in ``shape`` and, per axis, a group over the
    ranks that differ from it along that axis only."""
    coords = np.unravel_index(dist.get_rank(), shape)
    groups = {}
    for i, name in enumerate(names):
        ranks = []
        for j in range(shape[i]):
            at = list(coords)
            at[i] = j
            ranks.append(int(np.ravel_multi_index(at, shape)))
        groups[name] = dist.new_group(ranks, use_local_synchronization=True)
    return Mesh(dict(zip(names, shape)), device,
                coords={n: int(c) for n, c in zip(names, coords)}, groups=groups)


def _axis_size(mesh, name: Optional[str]) -> int:
    """Size of the mesh axis ``name`` (1 for no axis). ``mesh`` is any
    object with a ``shape`` mapping from axis names to sizes."""
    return mesh.shape[name] if name is not None else 1


def pad_to_multiple(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


# ---------------------------------------------------------------------------
# collectives: the only place the mesh engines and the LM zoo's sharded
# train step talk to torch.distributed
# ---------------------------------------------------------------------------
# calls made through torch.distributed, by kind (a process-group mesh only),
# and their bytes: the larger of the tensor sent and the tensor received
COLLECTIVES: collections.Counter = collections.Counter()
COLLECTIVE_BYTES: collections.Counter = collections.Counter()


def reset_collective_counts() -> None:
    COLLECTIVES.clear()
    COLLECTIVE_BYTES.clear()


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def _check_device(t: Tensor, mesh: Mesh) -> None:
    if t.device.type != mesh.device.type:
        raise ValueError(f"a tensor on {t.device} reached a collective of a mesh on {mesh.device}")


def all_gather(t: Tensor, mesh: Mesh, name: Optional[str]) -> Tensor:
    """Concatenate every position's ``t`` along dim 0 over axis ``name``
    (JAX's ``all_gather(..., tiled=True)``)."""
    g = mesh.group(name)
    if g is None:
        return t
    _check_device(t, mesh)
    out = t.new_empty((mesh.shape[name] * t.shape[0],) + tuple(t.shape[1:]))
    with warnings.catch_warnings():
        # newer torch deprecates it for all_gather_single, which older
        # releases lack
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous(), group=g)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVE_BYTES["all_gather"] += _nbytes(out)
    return out


def psum(t: Tensor, mesh: Mesh, name: Optional[str]) -> Tensor:
    """Sum of ``t`` over axis ``name``, as a new tensor."""
    g = mesh.group(name)
    if g is None:
        return t
    _check_device(t, mesh)
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVE_BYTES["all_reduce"] += _nbytes(out)
    return out


def all_gather_dim(t: Tensor, mesh: Mesh, name: Optional[str], dim: int) -> Tensor:
    """Concatenate every position's ``t`` along ``dim`` over axis ``name``
    (one ``all_gather`` call), as a contiguous tensor: a weight then has
    the layout, and its products the kernels, of the unsharded one. The
    blocks arrive stacked along dim 0 and are interleaved into place by one
    copy (none along dim 0, or over one position)."""
    if mesh.group(name) is None:
        return t
    dim = dim % t.dim()
    shape = tuple(t.shape)
    k = mesh.shape[name]
    g = all_gather(t, mesh, name).view((k,) + shape)
    return g.movedim(0, dim).reshape(shape[:dim] + (k * shape[dim],) + shape[dim + 1:])


def block_of(t: Tensor, mesh: Mesh, name: Optional[str], dim: int) -> Tensor:
    """This position's block of ``t`` along ``dim`` over axis ``name`` (a
    view; ``t.shape[dim]`` must split evenly)."""
    k = mesh.shape[name] if name is not None else 1
    if k == 1:
        return t
    size = t.shape[dim]
    if size % k:
        raise ValueError(f"dim {dim} of size {size} does not split over {name!r} = {k}")
    n = size // k
    return t.narrow(dim, mesh.coord(name) * n, n)


def psum_scatter(t: Tensor, mesh: Mesh, name: Optional[str], dim: int) -> Tensor:
    """The sum of ``t`` over axis ``name``, and of it this position's block
    along ``dim``: a reduce-scatter, made as a psum followed by a slice."""
    return block_of(psum(t, mesh, name), mesh, name, dim).contiguous()


class AllGather(torch.autograd.Function):
    """``all_gather_dim`` that autograd differentiates. The backward hands
    this position its block of the full gradient as it is: the positions
    along the axis hold the same batch (as the LM step's ``model`` axis
    does), so each computed the same full gradient."""

    @staticmethod
    def forward(ctx, t, mesh, name, dim):
        ctx.mesh, ctx.name, ctx.dim = mesh, name, dim
        return all_gather_dim(t, mesh, name, dim)

    @staticmethod
    def backward(ctx, g):
        return block_of(g, ctx.mesh, ctx.name, ctx.dim).contiguous(), None, None, None


def all_gather_grad(t: Tensor, mesh: Mesh, name: Optional[str], dim: int) -> Tensor:
    """``all_gather_dim`` under autograd (``AllGather``); the identity on
    an axis without a process group."""
    if mesh.group(name) is None:
        return t
    return AllGather.apply(t, mesh, name, dim)


def broadcast(t: Tensor, mesh: Mesh) -> Tensor:
    """The root's ``t`` on every rank of the mesh (in place)."""
    if not mesh.distributed:
        return t
    _check_device(t, mesh)
    dist.broadcast(t, src=0)
    COLLECTIVES["broadcast"] += 1
    COLLECTIVE_BYTES["broadcast"] += _nbytes(t)
    return t


def _gather_cols(t: Tensor, mesh: Mesh, name: Optional[str]) -> Tensor:
    """Concatenate along dim 1 over axis ``name``."""
    if mesh.group(name) is None:
        return t
    k = mesh.shape[name]
    g = all_gather(t, mesh, name).view((k,) + tuple(t.shape))
    return g.transpose(0, 1).reshape(t.shape[0], k * t.shape[1])


# a tree of tensors, floats, tuples, None and SigmaView dataclasses, sent
# from the root: the structure first (one small object), then each tensor
def _spec(obj):
    if obj is None:
        return ("none",)
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype)
    if isinstance(obj, SigmaView):
        return ("view", type(obj), [(f.name, _spec(getattr(obj, f.name)))
                                    for f in dataclasses.fields(obj)])
    if isinstance(obj, (tuple, list)):
        return ("tuple", [_spec(o) for o in obj])
    return ("float",)


def _send_tree(obj, spec, mesh: Mesh):
    kind = spec[0]
    if kind == "none":
        return None
    if kind == "tensor":
        t = obj.contiguous() if obj is not None else torch.empty(
            spec[1], dtype=spec[2], device=mesh.device)
        return broadcast(t, mesh)
    if kind == "float":
        t = torch.tensor([float(obj) if obj is not None else 0.0],
                         dtype=torch.float64, device=mesh.device)
        return float(broadcast(t, mesh).item())
    if kind == "view":
        return spec[1](**{name: _send_tree(getattr(obj, name) if obj is not None else None,
                                           s, mesh) for name, s in spec[2]})
    return tuple(_send_tree(obj[i] if obj is not None else None, s, mesh)
                 for i, s in enumerate(spec[1]))


def on_root(fn: Callable, mesh: Mesh, like=None):
    """Evaluate ``fn()`` on the root rank only and hand its value to every
    rank: a tensor, float, SigmaView, None or a tuple of them. ``like``
    (a tensor of the value's shape and dtype, or a float) spares sending
    the value's structure first."""
    if not mesh.distributed:
        return fn()
    obj = fn() if mesh.is_root else None
    if like is not None:
        spec = _spec(like)
    else:
        box = [_spec(obj) if mesh.is_root else None]
        dist.broadcast_object_list(box, src=0)
        COLLECTIVES["broadcast_object"] += 1
        spec = box[0]
        COLLECTIVE_BYTES["broadcast_object"] += len(pickle.dumps(spec))
    return _send_tree(obj, spec, mesh)


# ---------------------------------------------------------------------------
# data layout
# ---------------------------------------------------------------------------
def _pad_global(data: MTLData, mesh: Mesh, axes: MeshAxes) -> MTLData:
    """The task count padded to a multiple of ``data``, the feature dim to
    one of ``model`` and the sample dim to one of ``pod`` (zeros, mask 0;
    padded tasks have n = 1)."""
    m_pad = pad_to_multiple(data.m, _axis_size(mesh, axes.data))
    d_pad = pad_to_multiple(data.d, _axis_size(mesh, axes.model))
    n_pad = pad_to_multiple(data.n_max, _axis_size(mesh, axes.pod))
    d = data.pad_tasks(m_pad)
    if (n_pad, d_pad) == (d.n_max, d.d):
        return d
    x = d.x.new_zeros((m_pad, n_pad, d_pad))
    x[:, : d.n_max, : d.d] = d.x
    y = d.y.new_zeros((m_pad, n_pad))
    y[:, : d.n_max] = d.y
    mask = d.mask.new_zeros((m_pad, n_pad))
    mask[:, : d.n_max] = d.mask
    return MTLData(x, y, mask, d.n)


def _blocks(mesh: Mesh, axes: MeshAxes, m: int, n_max: int, d: int):
    """This rank's (task rows, sample columns, feature columns) slices."""
    m_loc = m // _axis_size(mesh, axes.data)
    n_loc = n_max // _axis_size(mesh, axes.pod)
    d_loc = d // _axis_size(mesh, axes.model)
    di, pi, mi = (mesh.coord(axes.data), mesh.coord(axes.pod), mesh.coord(axes.model))
    return (slice(di * m_loc, (di + 1) * m_loc), slice(pi * n_loc, (pi + 1) * n_loc),
            slice(mi * d_loc, (mi + 1) * d_loc))


def _local_data(full: MTLData, mesh: Mesh, axes: MeshAxes) -> MTLData:
    rows, cols, feats = _blocks(mesh, axes, full.m, full.n_max, full.d)
    return MTLData(
        full.x[rows, cols, feats].contiguous(),
        full.y[rows, cols].contiguous(),
        full.mask[rows, cols].contiguous(),
        full.n[rows].contiguous(),  # the tasks' global sample counts
    )


def shard_mtl_data(data: MTLData, mesh: Mesh, axes: MeshAxes) -> Tuple[MTLData, int, int]:
    """Pad the task count / feature dim / sample dim and keep this rank's
    block (``P(data, pod, model)`` for x, ``P(data, pod)`` for y and mask,
    ``P(data)`` for n). Every rank passes the same whole ``data``.

    Returns (local block, m_padded, d_padded)."""
    full = _pad_global(data.to(mesh.device), mesh, axes)
    return _local_data(full, mesh, axes), full.m, full.d


# ---------------------------------------------------------------------------
# the worker half of a round
# ---------------------------------------------------------------------------
def make_local_solve(
    cfg: DMTRLConfig,
    mesh: Mesh,
    axes: MeshAxes,
    m: int,
    n_max: int,
    d: int,
    rho: float,
    sigma_input: str = "rows",
):
    """The worker half of one communication round on this rank's block.

    Returns ``local_solve(x, y, n, alpha, W_read, sigma_rows, key) ->
    (dalpha, db)`` where ``W_read`` is the (possibly stale) weight block the
    worker solves against and ``db`` is this block's delta_b rows (summed
    over pods, eta/n-normalized) ready for the server reduce. ``n_max`` is
    the padded global sample count; ``key`` the round's key, the same on
    every rank.

    ``sigma_input`` names what the sigma argument carries: ``"rows"`` the
    dense (m_loc, m) Sigma rows (sigma_ii taken by global task id),
    ``"diag"`` just the local (m_loc,) diagonal (the structured layout).

    Without a ``model`` axis the configured backend's batched solver runs
    over the local tasks (``pallas_round`` launches the round kernel once,
    ``pallas_block`` the block kernel once per H-block). With one, each
    d-contraction needs a sum over the axis, which a kernel cannot make
    from inside, so the Gram form runs in torch: one (q, G) build summed
    over ``model`` for all local tasks (the full H x H Gram, or with
    ``dist_block_hoisted`` the B x B Gram, q and xr per block), then the
    scalar recursion; the same iterates as the other backends.
    """
    if sigma_input not in ("rows", "diag"):
        raise ValueError(f"sigma_input must be 'rows' or 'diag', got {sigma_input!r}")
    loss = get_loss(cfg.loss)
    m_loc = m // _axis_size(mesh, axes.data)
    n_loc = n_max // _axis_size(mesh, axes.pod)
    backend = get_backend(cfg.solver)
    H = backend.round_local_iters(cfg.local_iters or n_loc, cfg.block_size)
    use_gram = axes.model is not None
    solver = None if use_gram else backend.make(loss, rho, cfg.lam, H, block=cfg.block_size)
    di, pi = mesh.coord(axes.data), mesh.coord(axes.pod)
    # global task ids of this block + per-(task, pod, round) keys
    tids = di * m_loc + torch.arange(m_loc, dtype=torch.int64)
    gemm = torch.bfloat16 if cfg.gram_bf16 else None

    def rounded(t):
        # gram_bf16: X rounded to bf16, the products in fp32
        return t.to(gemm).to(t.dtype) if gemm is not None else t

    def msum(t):
        return psum(t, mesh, axes.model)

    def local_solve(x, y, n, alpha, W_read, sigma_rows, key):
        keys = prng.fold_in(prng.fold_in(key, tids), pi)  # (m_loc, 2)
        if sigma_input == "diag":
            sigma_ii = sigma_rows
        else:
            sigma_ii = sigma_rows[torch.arange(m_loc, device=sigma_rows.device),
                                  tids.to(sigma_rows.device)]
        # valid samples in this pod's contiguous slice
        n_local = torch.clamp(n - pi * n_loc, 0, n_loc).to(torch.int32)
        if use_gram:
            coords = sample_coords(keys, H, n_local, x.shape[1])  # (m_loc, H)
            if cfg.dist_block_hoisted:
                # the block Gram per H-block: 3 H B numbers a task summed
                # over the axis per round (H^2 for the full Gram)
                nf = torch.clamp(n, min=1).to(x.dtype)
                kap = rho * sigma_ii / (cfg.lam * nf)
                B = cfg.block_size
                dalpha = torch.zeros_like(alpha)
                r = torch.zeros_like(W_read)
                for b in range(H // B):
                    cb = coords[:, b * B : (b + 1) * B]
                    Xb = gather_rows(x, cb)  # (m_loc, B, d_loc)
                    Xg = rounded(Xb)
                    q = msum(torch.bmm(Xb, W_read[:, :, None])[..., 0])
                    xr = msum(torch.bmm(Xb, r[:, :, None])[..., 0])
                    G = msum(torch.bmm(Xg, Xg.transpose(1, 2)))
                    dalpha, deltas = sdca_block_solve(G, q, xr, dalpha, alpha, y, cb, kap, loss)
                    r = r + torch.bmm(Xb.transpose(1, 2), deltas[:, :, None])[..., 0]
            else:
                Xs = gather_rows(x, coords)  # (m_loc, H, d_loc)
                Xg = rounded(Xs)
                q = msum(torch.bmm(Xg, rounded(W_read)[:, :, None])[..., 0])
                G = msum(torch.bmm(Xg, Xg.transpose(1, 2)))
                dalpha, deltas = sdca_gram_solve(
                    G, q, alpha, y, coords, n_local, sigma_ii, rho, cfg.lam, loss
                )
                r = torch.bmm(Xs.transpose(1, 2), deltas[:, :, None])[..., 0]
        else:
            dalpha, r = solver(x, y, alpha, W_read, n_local, sigma_ii, keys)
        r = psum(r, mesh, axes.pod)
        # delta_b_i = (eta / n_i_global) * sum over ALL of task i's samples
        db = cfg.eta * r / torch.clamp(n, min=1)[:, None].to(r.dtype)
        return dalpha, db

    return local_solve


def server_reduce(cfg: DMTRLConfig, mesh: Mesh, axes: MeshAxes, sigma_rows: Tensor,
                  db: Tensor) -> Tensor:
    """The server half of one round: all_gather the workers' delta_b rows
    and apply the Sigma-coupled reduce for this block's W rows. ``db`` may
    be masked by the async tick so only arrived contributions count."""
    dB = all_gather(db, mesh, axes.data)  # (m, d_loc)
    return sigma_rows @ dB / cfg.lam  # (m_loc, d_loc)


def make_distributed_round(
    cfg: DMTRLConfig,
    mesh: Mesh,
    axes: MeshAxes,
    m: int,
    n_max: int,
    d: int,
    rho: float,
    structured: bool = False,
):
    """One round on this rank's blocks:

        round(x, y, n, alpha, W, sigma, key) -> (alpha, W)

    With ``structured=True`` the sigma argument is this rank's
    ``LowRankDiagSigma`` block (U and d rows, the whole core) and the
    server reduce is factored: instead of all-gathering the (m, d) delta_b
    block, each rank sums its (r, d) projection U_rows^T db over ``data`` —
    O(r d) collective bytes per round instead of O(m d) — then applies
    dW_rows = U_rows (C proj) + d_rows * db locally."""
    local_solve = make_local_solve(
        cfg, mesh, axes, m, n_max, d, rho, sigma_input="diag" if structured else "rows",
    )

    if structured:

        def round_fn(x, y, n, alpha, W, sv, key):
            dalpha, db = local_solve(x, y, n, alpha, W, sv.diag(), key)
            proj = psum(sv.U.T @ db, mesh, axes.data)  # (r, d_loc)
            dW = (sv.U @ (sv.core @ proj) + sv.d[:, None] * db) / cfg.lam
            return alpha + cfg.eta * dalpha, W + dW

    else:

        def round_fn(x, y, n, alpha, W, sigma_rows, key):
            dalpha, db = local_solve(x, y, n, alpha, W, sigma_rows, key)
            dW = server_reduce(cfg, mesh, axes, sigma_rows, db)
            return alpha + cfg.eta * dalpha, W + dW

    return round_fn


# ---------------------------------------------------------------------------
# Sigma on the mesh
# ---------------------------------------------------------------------------
def pad_sigma_blocks(sigma_t: Tensor, omega_t: Tensor, m: int, m_true: int, jitter: float):
    """Embed the real-task Sigma/Omega into padded (m, m) matrices. Padded
    tasks get an inert jitter-scaled identity block so they stay
    decoupled."""
    pad = m - m_true
    if not pad:
        return sigma_t, omega_t
    eye = torch.eye(pad, dtype=sigma_t.dtype, device=sigma_t.device)
    sigma = sigma_t.new_zeros((m, m))
    sigma[:m_true, :m_true] = sigma_t
    sigma[m_true:, m_true:] = eye * jitter
    omega = omega_t.new_zeros((m, m))
    omega[:m_true, :m_true] = omega_t
    omega[m_true:, m_true:] = eye / jitter
    return sigma, omega


def pad_sigma_any(sigma_t, omega_t, m: int, m_true: int, jitter: float):
    """pad_sigma_blocks generalized to SigmaView / missing-omega inputs:
    dense pairs go through pad_sigma_blocks, views pad via their own
    factor-level embedding."""
    if isinstance(sigma_t, SigmaView):
        sigma = sigma_t.pad(m, jitter)
        omega = omega_t.pad(m, 1.0 / jitter) if isinstance(omega_t, SigmaView) else None
        return sigma, omega
    if omega_t is None:
        sigma, _ = pad_sigma_blocks(sigma_t, sigma_t, m, m_true, jitter)
        return sigma, None
    return pad_sigma_blocks(sigma_t, omega_t, m, m_true, jitter)


def mesh_sigma(sigma):
    """The form a padded Sigma takes on the mesh: a ``LowRankDiagSigma``
    keeps its factors; any other view (sparse, dense) is made dense, as the
    JAX package's ``device_put_sigma`` does."""
    if sigma is None or isinstance(sigma, LowRankDiagSigma):
        return sigma
    if isinstance(sigma, SigmaView):
        return sigma.dense()
    return sigma


def sigma_rows(sigma, rows: slice):
    """This rank's rows of a mesh Sigma: (m_loc, m) dense rows, or a
    ``LowRankDiagSigma`` of its U and d rows with the whole core."""
    if sigma is None:
        return None
    if isinstance(sigma, LowRankDiagSigma):
        return LowRankDiagSigma(U=sigma.U[rows], core=sigma.core, d=sigma.d[rows])
    return sigma[rows]


def _densify_pair(sig, om):
    """Dense (Sigma, Omega) for the simulated transport's tick, which takes
    dense Sigma rows; a missing Omega becomes the inverse of the dense
    Sigma."""
    if isinstance(sig, SigmaView):
        sig = sig.dense()
        if om is None:
            om = torch.linalg.inv(sig)
    if isinstance(om, SigmaView):
        om = om.dense()
    return sig, om


class MeshRun:
    """The state of one SPMD run on a mesh, shared by ``fit_distributed`` and
    the ``simulated`` transport: this rank's data block and state, the
    padded whole Sigma/Omega (the same on every rank), and the root-computed
    quantities (rho, objectives, W(alpha), the Omega-step)."""

    def __init__(self, cfg: DMTRLConfig, raw: MTLData, mesh: Mesh, axes: MeshAxes, reg,
                 init: Optional[WarmStart] = None):
        for name in (axes.data, axes.model, axes.pod):
            if name is not None and name not in mesh.shape:
                raise ValueError(f"axis {name!r} is not an axis of the mesh {mesh.shape}")
        self.cfg, self.mesh, self.axes, self.reg = cfg, mesh, axes, reg
        self.loss = get_loss(cfg.loss)
        self.raw = raw.to(mesh.device)
        full = _pad_global(self.raw, mesh, axes)
        self.m, self.n_max, self.d = full.m, full.n_max, full.d
        self.data = _local_data(full, mesh, axes)
        # the root evaluates the objectives and W(alpha) on the whole data
        self.full = full if mesh.is_root else None
        self.rows, self.cols, self.feats = _blocks(mesh, axes, self.m, self.n_max, self.d)
        self.n_pods = _axis_size(mesh, axes.pod)
        self.n_workers = _axis_size(mesh, axes.data)
        dtype, dev = self.data.x.dtype, mesh.device
        alpha = torch.zeros(tuple(self.data.y.shape), dtype=dtype, device=dev)
        W = torch.zeros((self.data.m, self.data.d), dtype=dtype, device=dev)
        self.state = DistributedState(alpha, W, None, None)
        self.set_sigma(*omega_mod.init_sigma(self.m, dtype, dev))
        self._install_initial(init)

    # -- gathers and root values -------------------------------------------
    def gather_alpha(self) -> Tensor:
        """The whole padded (m, n_max) alpha on every rank."""
        a = _gather_cols(self.state.alpha, self.mesh, self.axes.pod)
        return all_gather(a, self.mesh, self.axes.data)

    def gather_W(self) -> Tensor:
        """The whole padded (m, d) W on every rank, in data order."""
        w = _gather_cols(self.state.W, self.mesh, self.axes.model)
        return all_gather(w, self.mesh, self.axes.data)

    def rho(self) -> float:
        return on_root(lambda: _rho_value(
            self.cfg, self.sigma, n_blocks_scale=float(self.n_pods), reg=self.reg), self.mesh,
            like=0.0)

    def objectives(self) -> Tuple[float, float]:
        """(dual, primal) of the current alpha under the current Sigma."""
        alpha = self.gather_alpha()

        def both():
            dd = dual_mod.dual_objective(self.full, alpha, self.sigma, self.cfg.lam, self.loss)
            pp = dual_mod.primal_objective_from_alpha(
                self.full, alpha, self.sigma, self.cfg.lam, self.loss)
            return torch.stack([dd, pp])

        dd, pp = on_root(both, self.mesh, like=alpha.new_empty(2)).tolist()
        return dd, pp

    # -- Sigma --------------------------------------------------------------
    def set_sigma(self, sigma, omega) -> None:
        """Install a padded (Sigma, Omega), the same on every rank."""
        self.sigma, self.omega = mesh_sigma(sigma), mesh_sigma(omega)
        self.state = dataclasses.replace(
            self.state, sigma=sigma_rows(self.sigma, self.rows),
            omega=sigma_rows(self.omega, self.rows))

    def refresh_W(self) -> None:
        """W = W(alpha) under the current Sigma (B does not depend on it)."""
        alpha = self.gather_alpha()
        W = on_root(lambda: dual_mod.weights_from_alpha(
            self.full, alpha, self.sigma, self.cfg.lam), self.mesh,
            like=alpha.new_empty((self.m, self.d)))
        self.state = dataclasses.replace(self.state, W=W[self.rows, self.feats].contiguous())

    def omega_step(self, densify: bool = False):
        """The Omega-step on the real tasks' W rows, run on the root and
        handed to every rank padded: (Sigma, Omega)."""
        W = self.gather_W()

        def step():
            sig, om = pad_sigma_any(*self.reg.step(W[: self.raw.m], self.cfg.omega_jitter),
                                    self.m, self.raw.m, self.cfg.omega_jitter)
            return _densify_pair(sig, om) if densify else (sig, om)

        return on_root(step, self.mesh)

    def _install_initial(self, init: Optional[WarmStart]) -> None:
        """A warm start (``init``) or a custom-init regularizer's Sigma, with
        W(alpha) rederived; every rank is handed the same ``init``."""
        reg = self.reg
        if init is None and not reg.custom_init and not reg.structured:
            return
        dtype, dev = self.data.x.dtype, self.mesh.device

        def tensor(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        if init is not None:
            sigma_t = init.sigma if isinstance(init.sigma, SigmaView) else tensor(init.sigma)
            omega_t = init.omega
            if omega_t is not None and not isinstance(omega_t, SigmaView):
                omega_t = tensor(omega_t)
        else:
            sigma_t, omega_t = reg.init(self.raw.m, dtype, dev)
        self.set_sigma(*pad_sigma_any(sigma_t, omega_t, self.m, self.raw.m,
                                      self.cfg.omega_jitter))
        if init is not None:
            alpha0 = torch.zeros((self.m, self.n_max), dtype=dtype, device=dev)
            alpha0[: self.raw.m, : self.raw.n_max] = tensor(init.alpha)
            self.state = dataclasses.replace(
                self.state, alpha=alpha0[self.rows, self.cols].contiguous())
            self.refresh_W()

    # -- results ------------------------------------------------------------
    def result_W_sigma(self):
        """(W, Sigma) at the raw problem size on every rank: W gathered,
        Sigma dense or, at huge m, a view."""
        W = self.gather_W()[: self.raw.m, : self.raw.d]
        if isinstance(self.sigma, SigmaView):
            sigma = maybe_dense(self.sigma.unpad(self.raw.m))
        else:
            sigma = self.sigma[: self.raw.m, : self.raw.m]
        return W, sigma

    def gathered_state(self) -> DistributedState:
        """The whole padded state on every rank."""
        return DistributedState(self.gather_alpha(), self.gather_W(), self.sigma, self.omega)


def gather_state(state: DistributedState, mesh: Mesh, axes: MeshAxes) -> DistributedState:
    """The whole padded state from every rank's blocks (``fit_distributed``'s
    ``state``): alpha and W gathered, Sigma/Omega rows gathered over
    ``data`` (a ``LowRankDiagSigma``'s U and d rows; the core is whole)."""

    def rows(s):
        if s is None:
            return None
        if isinstance(s, LowRankDiagSigma):
            return LowRankDiagSigma(U=all_gather(s.U, mesh, axes.data), core=s.core,
                                    d=all_gather(s.d, mesh, axes.data))
        return all_gather(s, mesh, axes.data)

    alpha = all_gather(_gather_cols(state.alpha, mesh, axes.pod), mesh, axes.data)
    W = all_gather(_gather_cols(state.W, mesh, axes.model), mesh, axes.data)
    return DistributedState(alpha, W, rows(state.sigma), rows(state.omega))


# ---------------------------------------------------------------------------
# the synchronous engine
# ---------------------------------------------------------------------------
def fit_distributed(
    cfg: DMTRLConfig,
    raw: MTLData,
    mesh: Mesh,
    axes: Optional[MeshAxes] = None,
    track: bool = True,
    *,
    options: Optional[DistributedOptions] = None,
    init: Optional[WarmStart] = None,
    regularizer=None,
):
    """Full Algorithm 1 on a mesh. Every rank calls it with the same
    ``raw`` and config. The same iterates as ``dmtrl.fit`` without a pod
    axis (to float association); with pods the CoCoA block structure is
    finer (m * pods blocks), so the iterates differ but the gap still
    shrinks.

    ``options`` overrides the config's two Gram fields and carries the axes
    when ``axes`` is None; ``init`` warm-starts from raw-shaped (alpha,
    sigma, omega); ``regularizer`` overrides the Omega family member.

    Returns (W, sigma, state, hist): W (m, d) and Sigma (m, m) (a view at
    huge m) at the raw size on the mesh's device, the same on every rank;
    ``state`` this rank's blocks; ``hist`` the objectives after every round
    and one commit receipt per worker and round (the tau = 0 member of the
    transports' event history).
    """
    if axes is None:
        axes = options.axes if options is not None else MeshAxes()
    if options is not None:
        cfg = options.merge_into(cfg)
    reg = omega_reg.resolve_regularizer(cfg, regularizer, m=raw.m)
    run = MeshRun(cfg, raw, mesh, axes, reg, init)
    key = prng.PRNGKey(cfg.seed)

    # the synchronous engine is the degenerate tau=0 transport: every round
    # commits all G workers as one barriered event with zero staleness/lag,
    # accounted through the transports' CommitReceipt path
    from .transport import CommitReceipt, new_event_history, record_receipt

    hist = new_event_history()
    rounds_seen = 0
    data = run.data
    for p in range(cfg.outer_iters):
        rho = run.rho()
        round_fn = make_distributed_round(
            cfg, mesh, axes, run.m, run.n_max, run.d, rho,
            structured=isinstance(run.sigma, LowRankDiagSigma),
        )
        # the key schedule of dmtrl.fit: the same coordinate draws
        key, outer_key = prng.split(key)
        round_keys = prng.split(outer_key, cfg.rounds)
        for t in range(cfg.rounds):
            st = run.state
            alpha, W = round_fn(data.x, data.y, data.n, st.alpha, st.W, st.sigma, round_keys[t])
            run.state = dataclasses.replace(st, alpha=alpha, W=W)
            commit = rounds_seen + t + 1
            for g in range(run.n_workers):
                record_receipt(hist, CommitReceipt(
                    worker=g, round=rounds_seen + t, staleness=0, lag=0,
                    tick=commit, version=commit, tau=0,
                ))
            hist["tau_trace"].append(0)
            hist["gate_refusals"].append(0)
            if track:
                dd, pp = run.objectives()
                hist["round"].append(commit)
                hist["tick"].append(commit)
                hist["dual"].append(dd)
                hist["primal"].append(pp)
                hist["gap"].append(pp - dd)
                hist["min_round"].append(rounds_seen + t + 1)
        rounds_seen += cfg.rounds
        if reg.learns:
            # the Omega-step sees only the real tasks; padded (inert) tasks
            # would distort the trace-1 normalization
            run.set_sigma(*run.omega_step())
            run.refresh_W()

    hist_np = {k: np.asarray(v) for k, v in hist.items()}
    W, sigma = run.result_W_sigma()
    return W, sigma, run.state, hist_np
