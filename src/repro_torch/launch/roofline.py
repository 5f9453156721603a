"""Roofline terms of one traced step — the port of
``repro.launch.roofline``.

Three terms per (arch × shape × mesh), in seconds, on one NVIDIA H100 SXM5
(NVIDIA H100 Tensor Core GPU datasheet, dense rates without sparsity):

    compute    = per_rank_FLOPs / 989.4e12    (BF16 tensor cores; the
                                               datasheet's 1 979 assumes
                                               2:4 sparsity)
    memory     = per_rank_bytes / 3.35e12     (HBM3)
    collective = per_rank_collective_bytes / 450e9
                                              (NVLink: 900 GB/s a GPU, 450
                                               each way; the reference's
                                               ``ici_bw`` key)

A card's NVLink domain holds 8 GPUs.  A 16-wide mesh dim spans two of
them, so its collectives cross the slower network between hosts, and the
collective term is a lower bound there.

There is no compiled module to read: :class:`StepTrace` watches one step
run on each rank's local tensors (under ``FakeTensorMode`` in the dry-run,
on the card's own tensors in ``chip_smoke.py``) and counts, per rank:

* FLOPs by ``torch.utils.flop_counter``'s formulas (the WKV's registered
  by :mod:`repro_torch.kernels.wkv6`), for the ops one rank runs on its
  local shards — DTensor ops are let through to their local ops, and
  DTensor's sharding propagation (run on tensors of another fake mode) is
  not counted;
* HBM bytes: every op's input and output bytes (views and allocations
  that write nothing excepted, an in-place scatter's destination counted
  by the slots it writes) — what an unfused eager step reads and writes;
* the output bytes of each collective by the reference's five kinds, an
  all-reduce twice (a ring's reduce-scatter + all-gather), for the c10d
  functional ops and the in-place ``c10d`` ones (the sharded embedding's
  ``dist.all_reduce``);
* device memory: the live bytes of the rank's storages — the arguments
  (params, optimizer state, batch, caches), the peak and the step's
  temporaries above the arguments.

``MODEL_FLOPS`` is 6·N·D (dense) or 6·N_active·D (MoE) with D = tokens per
step; MODEL_FLOPS / (per-rank FLOPs × ranks) exposes remat and dispatch
overheads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..models import ArchConfig, ShapeCell

__all__ = ["HW", "StepTrace", "roofline_from_trace", "model_flops",
           "RooflineReport", "COLLECTIVES"]

# NVIDIA H100 SXM5, dense: BF16 tensor cores, HBM3, NVLink each way
HW = dict(peak_flops=989.4e12, hbm_bw=3.35e12, ici_bw=450e9)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op name (functional and in-place) → the reference's kind
_KIND = {}
for _kind, _names in (
        ("all-gather", ("all_gather_into_tensor",
                        "all_gather_into_tensor_coalesced", "allgather_",
                        "_allgather_base_", "allgather_coalesced_",
                        "allgather_into_tensor_coalesced_")),
        ("all-reduce", ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                        "all_reduce_coalesced_", "allreduce_",
                        "allreduce_coalesced_")),
        ("reduce-scatter", ("reduce_scatter_tensor",
                            "reduce_scatter_tensor_coalesced",
                            "reduce_scatter_", "_reduce_scatter_base_",
                            "reduce_scatter_tensor_coalesced_")),
        ("all-to-all", ("all_to_all_single", "alltoall_", "alltoall_base_")),
        ("collective-permute", ("send", "recv_", "recv_any_source_"))):
    for _n in _names:
        _KIND[_n] = _kind

#: ops that read and write no device memory of their own
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "wait_tensor",
               "lift_fresh", "device", "resize_", "set_"}

#: in-place writes into a few slots of their first argument
_SCATTER = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
            "scatter_add_", "scatter_reduce_", "index_add_",
            "masked_scatter_"}

#: FlopCounterMode's size queries, which it leaves to the tensor
_QUERIES = {"sym_is_contiguous", "is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "size", "sym_size", "stride",
            "sym_stride", "storage_offset", "sym_storage_offset", "numel",
            "sym_numel", "dim", "layout"}


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace:
    """Per-rank counts of what runs inside it: ``flops``, ``hbm_bytes``,
    ``coll`` (bytes by collective kind), ``ops`` (local ops run) and
    ``memory`` (bytes: the ``arguments`` by group,
    ``argument_size_in_bytes``, ``peak_size_in_bytes`` and
    ``temp_size_in_bytes``, the peak above the arguments).

    Memory is the live bytes of the storages the rank's tensors hold: the
    arguments' and every storage a counted op makes, each released with
    its last reference.  (torch's ``MemTracker`` keeps the same account,
    but not every torch release tells its ops from DTensor's propagation
    ones, which run on whole-tensor shapes.)

    Enter it inside the step's ``FakeTensorMode`` (or outside any, on real
    tensors): ops run under another fake mode — DTensor's sharding
    propagation — are not the rank's work.  ``arguments`` maps a group
    name to a tree of tensors (DTensors count their local shards)."""

    def __init__(self, arguments: Optional[Dict[str, Any]] = None):
        from torch.utils.weak import WeakIdKeyDictionary
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.coll: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.memory: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._held = WeakIdKeyDictionary()
        self._arguments = arguments or {}
        self._mode = None
        self._prop = None

    def hold(self, tensors) -> None:
        """Count the storages of ``tensors`` not yet held as live until
        each is released."""
        for t in tensors:
            st = t.untyped_storage()
            nb = st.nbytes()
            if nb == 0 or st in self._held:
                continue
            self._held[st] = nb
            self.live += nb
            weakref.finalize(st, self._release, nb)
        self.peak = max(self.peak, self.live)

    def _release(self, nb: int) -> None:
        self.live -= nb

    def __enter__(self):
        from torch._guards import active_fake_mode
        for group, tree in self._arguments.items():
            before = self.live
            self.hold(_local(_tensors(tree)))
            self.memory[f"{group}_bytes"] = float(self.live - before)
        self.memory["argument_size_in_bytes"] = float(self.live)
        self._mode = _CountMode(self, active_fake_mode())
        self._prop = _own_propagation_mode()
        self._prop.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        self._prop.__exit__(*exc)
        self.memory["peak_size_in_bytes"] = float(self.peak)
        self.memory["temp_size_in_bytes"] = float(
            self.peak - self.memory["argument_size_in_bytes"])
        return False


@contextlib.contextmanager
def _own_propagation_mode():
    """DTensor's sharding propagation, for the body of the ``with``, runs
    outside the step's fake mode and from its cache.

    Under an active fake mode DTensor takes itself to be tracing: it skips
    its propagation cache and runs its host-side index arithmetic, and each
    op once on whole-tensor shapes, under that mode — so those ops would
    pass for the rank's own, and index arithmetic that reads a value back
    fails on fake tensors.  Outside it, the shapes are worked out under a
    fake mode of its own (:class:`_CountMode` tells its ops apart), the
    arithmetic on real host tensors, and each op schema once, as in an
    eager step."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor, placement_types
    prop = DTensor._op_dispatcher.sharding_propagator
    cached = prop.propagate_op_sharding
    strided = placement_types._StridedShard
    sizes = strided.local_shard_size_and_offset

    def outside(op_schema):
        with unset_fake_temporarily():
            return cached(op_schema)

    def strided_sizes(*args, **kwargs):
        # a strided shard's sizes are host index arithmetic too
        with unset_fake_temporarily():
            return sizes(*args, **kwargs)
    prop.propagate_op_sharding_non_cached = outside
    strided.local_shard_size_and_offset = strided_sizes
    try:
        yield
    finally:
        del prop.propagate_op_sharding_non_cached
        strided.local_shard_size_and_offset = sizes


class _CountMode(TorchDispatchMode):
    """:class:`StepTrace`'s dispatch mode: counts into ``trace`` the ops
    run under ``fake`` (the step's fake mode, or None on real tensors)."""

    def __init__(self, trace: StepTrace, fake):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self._trace = trace
        self._fake = fake

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        name = func._opname
        if name in _QUERIES:
            return NotImplemented
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run: its local ops come back here
            return NotImplemented
        if active_fake_mode() is not self._fake:
            return func(*args, **kwargs)        # sharding propagation
        if name == "wait_tensor" and self._fake is not None:
            # an eager wait returns its input; a fake one a new tensor,
            # which would hold the collective's output twice
            return args[0]
        packet = func._overloadpacket
        if packet not in self._registry and name != "device":
            # as FlopCounterMode: count a decomposable op's pieces
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        tr = self._trace
        tr.ops += 1
        tr.hold(_tensors(out))
        if packet in self._registry:
            tr.flops += int(self._registry[packet](*args, **kwargs,
                                                   out_val=out))
        if func.namespace in ("_c10d_functional", "c10d") \
                and name in _KIND:
            outs = _tensors(out) or _tensors(args)[:1]
            nb = sum(_nbytes(t) for t in outs)
            kind = _KIND[name]
            tr.coll[kind] += 2 * nb if kind == "all-reduce" else nb
        if not func.is_view and name not in _NO_TRAFFIC:
            ins = _tensors((args, kwargs))
            outs = _tensors(out)
            if name == "copy_":
                ins = ins[1:]                   # the destination is written
            elif name in _SCATTER:
                # the destination's written slots only: the values' bytes
                dest, ins = ins[0], ins[1:]
                outs = [t for t in ins if t.dtype == dest.dtype]
            tr.hbm_bytes += sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        return out


def _local(ts):
    from ..parallel.ops import is_dtensor
    return [t.to_local() if is_dtensor(t) else t for t in ts]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    cell: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops_total: float
    useful_ratio: float               # MODEL_FLOPS / (FLOPs × ranks)
    bottleneck: str
    memory_analysis: Dict[str, float]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ArchConfig, cell: ShapeCell) -> float:
    """6·N·D with N = active params, D = tokens processed by the step."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens          # forward only
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def roofline_from_trace(trace: StepTrace, cfg: ArchConfig, cell: ShapeCell,
                        mesh_desc: str, n_chips: int) -> RooflineReport:
    """The report of one rank's traced step (:class:`StepTrace`):
    ``flops_per_device`` its FLOPs, ``bytes_per_device`` its eager HBM
    traffic (each op's inputs and outputs on the rank's local shards: what
    an unfused eager step reads and writes), the collective bytes by kind,
    and ``memory_analysis`` the trace's arguments, peak and temporaries."""
    flops = float(trace.flops)
    byts = float(trace.hbm_bytes)
    coll = dict(trace.coll)
    coll_total = float(sum(coll.values()))
    t_c = flops / HW["peak_flops"]
    t_m = byts / HW["hbm_bw"]
    t_x = coll_total / HW["ici_bw"]
    mf = model_flops(cfg, cell)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return RooflineReport(
        arch=cfg.name, cell=cell.name, mesh=mesh_desc,
        flops_per_device=flops, bytes_per_device=byts,
        coll_bytes_per_device=coll_total, coll_breakdown=coll,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        model_flops_total=mf, useful_ratio=mf / max(flops * n_chips, 1.0),
        bottleneck=max(terms, key=terms.get),
        memory_analysis=dict(trace.memory))
