"""Roofline terms of one traced step, and the cost counter that traces it.

The JAX package compiles a step for the production mesh and reads XLA's
cost analysis and the optimized HLO (``roofline/hlo_parse.py``). Torch has
neither, so the port counts as the step runs. ``CostCounter`` is a
``TorchDispatchMode``: it sees every aten op below autograd, on any device
(the card, the CPU, or ``meta`` tensors, which hold shapes and no data),
and keeps, for the one device whose ops it sees:

  * FLOPs: the matmul family's, by ``torch.utils.flop_counter``'s
    formulas (elementwise work is not counted, as the JAX package's dot
    FLOPs do not count it);
  * bytes: each op's tensor inputs read once and its outputs written once
    (an in-place op's tensor both), where a view, an alias and an
    allocation move nothing. This is the unfused counterpart of XLA's
    "bytes accessed": a fused XLA loop reads and writes less. A copy
    between the host and the device is left out: it crosses the host
    link, not device memory, and a run on the CPU has none;
  * the hand-written kernels, each counted once at its dispatcher
    (``launch``) by its own formula, and none of the ops that run
    underneath it (the plain version on the CPU, the kernel on the card,
    the shape rule on meta), so the three devices count alike;
  * collective calls and bytes by kind, from ``core.distributed``'s
    ``COLLECTIVES`` and ``COLLECTIVE_BYTES`` (the larger of the tensor sent
    and the tensor received: JAX's "largest shape on the line"); the c10d
    ops themselves add no bytes;
  * the peak of live bytes: the storages created inside the context, each
    freed when its last reference dies.

Every op is counted, the host's few bookkeeping ones too (a prefill's
positions, a round's key folds), so a run on the CPU, on meta and on the
card count alike. Remat's recompute runs under the counter as it runs on
the card, so every layer and every recompute is counted: the JAX package
weights its HLO's loops by their trip counts to the same end.
``roofline/hlo_parse.py`` has no counterpart, since there is no HLO.

With no counter active, a kernel dispatcher pays one read of ``ACTIVE``.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# the counter in effect (at most one), read by the kernels' dispatchers
ACTIVE: Optional["CostCounter"] = None

_aten = torch.ops.aten
# an alias the schema does not mark as one
_ALIASES = frozenset({_aten._unsafe_view.default})
# allocations that write nothing
_NO_WRITE = frozenset({
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
})
# copies, which cross between the host and the device when their tensors
# lie on both
_COPIES = frozenset({_aten._to_copy.default, _aten.copy_.default})
_KINDS: Dict[object, Tuple[bool, bool]] = {}
_META = torch.device("meta")


class _Uncached(Exception):
    pass


def _kind(func) -> Tuple[bool, bool]:
    """(aliases: the outputs are views of an input, fresh: the outputs are
    new storages) of an aten op, from its schema."""
    k = _KINDS.get(func)
    if k is None:
        alias = func.is_view or func in _ALIASES
        fresh = not alias and all(r.alias_info is None for r in func._schema.returns)
        k = _KINDS[func] = (alias, fresh)
    return k


def _tensors(items):
    """The tensors among ``items`` and the lists in it."""
    for a in items:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


def _signature(a):
    """A hashable stand-in for an op argument that fixes a meta op's output
    layout: a meta tensor's shape, strides and dtype, a value with its type
    (1 and 1.0 give different dtypes); _Uncached for anything else."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise _Uncached
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_signature(b) for b in a)
    return (type(a), a)


def _layout(out):
    """(shape, strides, dtype) of each tensor of a fresh meta op's output."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, (tuple, list)) and all(isinstance(t, torch.Tensor) for t in out):
        return (type(out),) + tuple(_layout(t) for t in out)
    raise _Uncached


def _empty(layout):
    if isinstance(layout[0], type):
        return layout[0](_empty(x) for x in layout[1:])
    shape, stride, dtype = layout
    return torch.empty_strided(shape, stride, dtype=dtype, device=_META)


def _crosses(func, args, outs) -> bool:
    """Whether ``func`` copies between the host and another device."""
    if func not in _COPIES:
        return False
    kinds = {t.device.type for t in _tensors(list(args) + list(outs))}
    return len(kinds) > 1 and "cpu" in kinds


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes one pass over ``t`` moves: its elements, or fewer where a
    stride of 0 repeats them."""
    n = t.numel()
    if n and 0 in t.stride():
        n = min(n, 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride())))
    return n * t.element_size()


@dataclasses.dataclass
class Costs:
    """One device's counts over a traced region (see the module's text)."""

    flops: int = 0
    bytes: int = 0
    ops: int = 0
    kernels: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    kernel_flops: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    kernel_bytes: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collectives: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    collective_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    peak_bytes: int = 0

    def counted(self) -> Dict[str, object]:
        """What two runs of one step must agree on exactly: FLOPs, bytes,
        kernel launches and collective calls and bytes by kind."""
        return {"flops": self.flops, "bytes": self.bytes, "kernels": dict(self.kernels),
                "collectives": dict(self.collectives),
                "collective_bytes": dict(self.collective_bytes)}


class CostCounter(TorchDispatchMode):
    """Counts the ops run inside ``with CostCounter() as c:`` into
    ``c.costs``. One counter at a time; it sets ``ACTIVE`` while open."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._paused = 0
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._coll0 = None
        # the output layouts of fresh ops on meta tensors, by op and input
        # signature: many of torch's meta kernels are Python references
        # (0.2-0.7 ms an op), and a step repeats its signatures layer after
        # layer
        self._layouts: Dict[tuple, tuple] = {}

    def __enter__(self):
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("a cost counter is already active")
        from ..core import distributed as dist_mod

        self._coll0 = (collections.Counter(dist_mod.COLLECTIVES),
                       collections.Counter(dist_mod.COLLECTIVE_BYTES))
        out = super().__enter__()
        ACTIVE = self
        return out

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = None
        from ..core import distributed as dist_mod

        calls0, bytes0 = self._coll0
        self.costs.collectives = collections.Counter(dist_mod.COLLECTIVES) - calls0
        self.costs.collective_bytes = collections.Counter(dist_mod.COLLECTIVE_BYTES) - bytes0
        return super().__exit__(*exc)

    # -- the kernels' dispatchers -------------------------------------------
    def launch(self, name: str, cost: Tuple[int, int], fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` counted as one launch of kernel ``name``
        with ``cost = (flops, bytes)``, and none of the ops inside it. A
        launch inside another kernel's plain version is not counted."""
        if not self._paused:
            c = self.costs
            flops, nbytes = int(cost[0]), int(cost[1])
            c.kernels[name] += 1
            c.kernel_flops[name] += flops
            c.kernel_bytes[name] += nbytes
            c.flops += flops
            c.bytes += nbytes
        self._paused += 1
        try:
            return fn(*args, **kwargs)
        finally:
            self._paused -= 1

    # -- every aten op ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":  # collectives: counted by core.distributed
            return func(*args, **kwargs)
        alias, fresh = _kind(func)
        out = self._run_fresh(func, args, kwargs) if fresh else func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if fresh:
            self._track(outs, args)
        if self._paused:
            return out
        c = self.costs
        c.ops += 1
        rule = flop_registry.get(func._overloadpacket)
        if rule is not None:
            c.flops += int(rule(*args, **kwargs, out_val=out))
        if not alias and func not in _NO_WRITE and not _crosses(func, args, outs):
            seen = set()
            n = 0
            for t in _tensors(list(args) + list(kwargs.values())):
                if id(t) not in seen:
                    seen.add(id(t))
                    n += tensor_bytes(t)
            c.bytes += n + sum(tensor_bytes(t) for t in _tensors(outs))
        return out

    def _run_fresh(self, func, args, kwargs):
        """``func(*args, **kwargs)`` for an op that writes fresh outputs: on
        meta tensors from the layout that op and signature gave before (no
        meta kernel runs), else by running it."""
        try:
            key = (func, _signature(args), _signature(tuple(kwargs.items())))
            if next(_tensors(args), None) is None:
                raise _Uncached  # a factory: its device is an argument
            layout = self._layouts.get(key)
        except (_Uncached, TypeError):  # not all meta, or an unhashable argument
            return func(*args, **kwargs)
        if layout is not None:
            return _empty(layout)
        out = func(*args, **kwargs)
        try:
            self._layouts[key] = _layout(out)
        except _Uncached:
            pass
        return out

    def _track(self, outs, args) -> None:
        """Add each new storage among ``outs`` to the live bytes until its
        last reference dies."""
        for t in _tensors(outs):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            if any(a.untyped_storage() is st for a in _tensors(args)):
                continue  # an input handed back
            nb = st.nbytes()
            if not nb:
                continue
            self._live[key] = nb
            self._live_bytes += nb
            if self._live_bytes > self.costs.peak_bytes:
                self.costs.peak_bytes = self._live_bytes
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)


@dataclasses.dataclass
class RooflineTerms:
    """The JAX package's roofline row, from a trace instead of a compile.
    ``memory_analysis`` states the trace's peak of live bytes (XLA's memory
    analysis in JAX); ``xla_flops_raw`` and ``xla_bytes_raw`` are JAX's
    loop-unaware XLA numbers and stay 0 here (no XLA). The last four
    fields are the port's own."""

    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, int]
    collective_counts: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6 N_active D for a train step (global)
    useful_flops_ratio: float
    memory_analysis: Optional[str] = None
    xla_flops_raw: float = 0.0
    xla_bytes_raw: float = 0.0
    peak_bytes_per_device: int = 0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops_per_device: int = 0

    def to_row(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def roofline_terms(
    costs: Costs,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_chips: int,
    model_flops: float,
    peak_flops: Optional[float] = None,
    hbm_bw: Optional[float] = None,
    link_bw: Optional[float] = None,
) -> RooflineTerms:
    """The three terms of one device's ``costs``: compute = FLOPs /
    ``peak_flops``, memory = bytes / ``hbm_bw``, collective = collective
    bytes / ``link_bw``; by default the H100's ``PEAK_FLOPS_BF16``,
    ``HBM_BW`` and ``NVLINK_BW`` (``launch.mesh``). NVLink's one-way rate
    is a lower bound on the collective time of an axis that crosses
    nodes. ``useful_flops_ratio`` is ``model_flops`` over the FLOPs of all
    ``n_chips`` devices."""
    from ..launch import mesh as mesh_mod

    peak_flops = mesh_mod.PEAK_FLOPS_BF16 if peak_flops is None else peak_flops
    hbm_bw = mesh_mod.HBM_BW if hbm_bw is None else hbm_bw
    link_bw = mesh_mod.NVLINK_BW if link_bw is None else link_bw
    coll = {k: int(v) for k, v in sorted(costs.collective_bytes.items())}
    coll_total = float(sum(coll.values()))
    compute_s = costs.flops / peak_flops
    memory_s = costs.bytes / hbm_bw
    collective_s = coll_total / link_bw
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    global_flops = float(costs.flops) * n_chips
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        flops_per_device=float(costs.flops),
        bytes_per_device=float(costs.bytes),
        collective_bytes_per_device=coll_total,
        collective_breakdown=coll,
        collective_counts={k: int(v) for k, v in sorted(costs.collectives.items())},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=float(model_flops),
        useful_flops_ratio=float(model_flops) / global_flops if global_flops > 0 else 0.0,
        memory_analysis=f"peak live bytes of the traced step: {costs.peak_bytes}",
        peak_bytes_per_device=int(costs.peak_bytes),
        kernel_launches={k: int(v) for k, v in sorted(costs.kernels.items())},
        kernel_flops={k: int(v) for k, v in sorted(costs.kernel_flops.items())},
        ops_per_device=int(costs.ops),
    )
