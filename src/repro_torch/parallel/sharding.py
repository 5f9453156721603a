"""Sharding rules: parameter / activation / cache partition specs — the
port of ``repro.parallel.sharding``.

Strategy (the reference's):
* tensor-parallel ("model" mesh dim): attention heads, FFN hidden, MoE
  experts, vocab — classic Megatron splits;
* fully-sharded data-parallel (the ("pod", "data") dims): the largest
  remaining dim of every ≥2D weight is sharded across the data dims
  (ZeRO-3: weights are gathered on use);
* KV heads replicate when ``n_kv_heads`` doesn't divide the model dim;
* 1D params (norm gains, biases) replicate.

The rules are path- and shape-driven, so they apply to every architecture
without per-arch tables.  A leaf's rule is a :class:`PartitionSpec`: one
entry per tensor dim, ``None`` (replicated), a mesh dim's name, or a tuple
of names (the dim split over several mesh dims, the first outermost) — the
values ``jax.sharding.PartitionSpec`` holds in the reference.  It becomes
DTensor placements only when a tensor is distributed
(:func:`placements`, :func:`distribute`).

``mesh`` is a :class:`torch.distributed.device_mesh.DeviceMesh` (its
``mesh_dim_names`` and ``shape``) or any object with the reference mesh's
``axis_names`` and ``shape`` (a name → size mapping), so the rules can be
read without a process group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

from .. import _tree

__all__ = ["PartitionSpec", "param_shardings", "batch_sharding",
           "cache_shardings", "opt_state_shardings", "data_axes_of",
           "mesh_shape", "placements", "distribute", "is_spec",
           "shard_params", "replicated", "local_nbytes"]


class PartitionSpec(tuple):
    """One leaf's sharding: an entry per tensor dim (see the module
    docstring).  A tuple subclass, so the tree walks stop at it
    (:func:`is_spec`) and it compares equal to the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def is_spec(t) -> bool:
    return isinstance(t, PartitionSpec)


def mesh_shape(mesh) -> Dict[str, int]:
    """Mesh dim name → size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_shape(mesh) if a != "model")


def _dp(shape: Dict[str, int], daxes) -> int:
    return math.prod(shape[a] for a in daxes) if daxes else 1


def _tp_dim(path: str, shape: Tuple[int, ...]) -> Optional[int]:
    """Which dim gets the 'model' dim for this leaf, or None."""
    nd = len(shape)
    # embeddings
    if path.endswith("embed.tok"):
        return 0                       # vocab rows
    if path.endswith("embed.out"):
        return 1                       # vocab cols
    # attention
    if path.endswith(".wq") or path.endswith("wq_b"):
        return 1                       # heads
    if path.endswith(".wk") or path.endswith(".wv"):
        return 1                       # kv heads (checked divisible by caller)
    if path.endswith(".wo") and nd == 3:
        return 0                       # heads
    if path.endswith("wk_b") or path.endswith("wv_b"):
        return 1                       # MLA heads
    # dense / shared FFN
    if path.endswith("w_in") and nd == 2:
        return 1
    if path.endswith("w_gate") and nd == 2:
        return 1
    if path.endswith("w_out") and nd == 2:
        return 0
    if "shared_in" in path or "shared_gate" in path:
        return 1
    if "shared_out" in path:
        return 0
    # MoE experts (E, d, f) / (E, f, d)
    if nd == 3 and (path.endswith("ffn.w_in") or path.endswith("ffn.w_gate")
                    or path.endswith("ffn.w_out")):
        return 0                       # expert axis
    # mamba
    if path.endswith("mixer.w_in") and nd == 2:
        return 1
    if path.endswith("mixer.w_out") and nd == 2:
        return 0
    if path.endswith("w_bcdt") or path.endswith("a_log"):
        return 0
    if path.endswith("mixer.conv"):
        return 1
    # rwkv
    if any(path.endswith(s) for s in (".wr", ".wk", ".wv", ".wg")) and nd == 2:
        return 1
    if path.endswith(".u") and nd == 2:
        return 0                       # heads
    return None


def _spec_for(path: str, shape: Tuple[int, ...], mesh, *, fsdp: bool = True,
              stacked: bool = False, moe_full_ep: bool = False
              ) -> PartitionSpec:
    """The PartitionSpec of one leaf.  ``stacked`` marks a leading
    n_repeats axis (the stacked blocks) that stays unsharded."""
    ms = mesh_shape(mesh)
    model = ms.get("model", 1)
    daxes = data_axes_of(mesh)
    dp = _dp(ms, daxes)
    off = 1 if stacked else 0
    body = shape[off:]
    spec: list = [None] * len(shape)
    dspec = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)

    # full-mesh expert parallelism: (E, d, f) → (E/dp, d, f/tp)
    if moe_full_ep and len(body) == 3 and (
            path.endswith("ffn.w_in") or path.endswith("ffn.w_gate")
            or path.endswith("ffn.w_out")) and body[0] % dp == 0:
        spec[off + 0] = dspec
        hid = 2 if path.endswith("ffn.w_in") or path.endswith("ffn.w_gate") \
            else 1
        if body[hid] % model == 0 and model > 1:
            spec[off + hid] = "model"
        return PartitionSpec(*spec)

    td = _tp_dim(path, body)
    if td is not None and body[td] % model == 0 and model > 1:
        spec[off + td] = "model"

    if fsdp and dp > 1 and len(body) >= 2:
        # shard the largest remaining dim over the data dims
        cands = [i for i in range(len(body)) if spec[off + i] is None
                 and body[i] % dp == 0]
        if cands:
            big = max(cands, key=lambda i: body[i])
            if body[big] >= 2 * dp:     # don't shred small dims
                spec[off + big] = dspec
    return PartitionSpec(*spec)


def _paths(tree: Any, prefix: str = ""):
    """(path, leaf) pairs with dict keys joined by '.', list items [i]."""
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += _paths(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out += _paths(v, f"{prefix}[{i}]")
    else:
        out.append((prefix, tree))
    return out


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, or a ``(shape, dtype)`` template's."""
    if isinstance(leaf, tuple) and len(leaf) == 2 \
            and isinstance(leaf[0], tuple):
        return tuple(leaf[0])
    return tuple(leaf.shape)


def _rebuild(tree, fn, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def param_shardings(params_shapes: Any, mesh, *, fsdp: bool = True,
                    moe_full_ep: bool = False):
    """The PartitionSpec tree of a params tree (tensors, or ``(shape,
    dtype)`` leaves).  Leaves under 'blocks'/'enc_blocks' have a leading
    stacked n_repeats axis."""
    def spec(path, leaf):
        stacked = ("blocks" in path.split(".")[0] or ".blocks." in path
                   or path.startswith("enc_blocks"))
        return _spec_for(path, _shape(leaf), mesh, fsdp=fsdp,
                         stacked=stacked, moe_full_ep=moe_full_ep)
    return _rebuild(params_shapes, spec)


def batch_sharding(mesh, batch_shape: Tuple[int, ...], *,
                   batch_dim: int = 0) -> PartitionSpec:
    """Shard the batch dim over the data dims when divisible, else
    replicate (e.g. a global batch of 1)."""
    daxes = data_axes_of(mesh)
    dp = _dp(mesh_shape(mesh), daxes)
    spec: list = [None] * len(batch_shape)
    if dp > 1 and batch_shape[batch_dim] % dp == 0:
        spec[batch_dim] = daxes if len(daxes) > 1 else daxes[0]
    return PartitionSpec(*spec)


def _is_template(t) -> bool:
    return isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], tuple)


def cache_shardings(cache_shapes: Any, mesh, batch: int):
    """KV caches: batch over the data dims when divisible; otherwise shard
    the sequence axis (long-context single-request decode); a heads-like
    trailing dim on 'model' when divisible.  ``cache_shapes`` holds
    tensors or :func:`~repro_torch.models.init_cache_shapes`' ``(shape,
    dtype)`` leaves."""
    ms = mesh_shape(mesh)
    daxes = data_axes_of(mesh)
    dp = _dp(ms, daxes)
    model = ms.get("model", 1)
    dspec = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)

    def spec_of(leaf):
        shp = _shape(leaf)
        spec: list = [None] * len(shp)
        # layout: (n_repeats, batch, seq, heads/dims...) or (batch, ...)
        bdim = 1 if len(shp) >= 2 and shp[0] != batch else 0
        if bdim < len(shp) and shp[bdim] == batch and batch % dp == 0 \
                and dp > 1:
            spec[bdim] = dspec
        elif len(shp) > bdim + 1 and shp[bdim + 1] % dp == 0 and dp > 1 \
                and shp[bdim + 1] >= 4 * dp:
            spec[bdim + 1] = dspec      # sequence sharding fallback
        # try the model dim on a heads-like trailing dim
        for dim in range(len(shp) - 1, bdim + 1, -1):
            if spec[dim] is None and shp[dim] % model == 0 and model > 1 \
                    and shp[dim] >= model:
                spec[dim] = "model"
                break
        return PartitionSpec(*spec)

    return _tree.map(spec_of, cache_shapes, is_leaf=_is_template)


def opt_state_shardings(opt_shapes: Any, params_shardings: Any):
    """Optimizer-state specs.

    AdamW moments mirror the parameter specs exactly.  Adafactor's
    factored second moment inherits the parent spec with the reduced dim
    dropped (row = spec[:-1], col = spec[:-2] + spec[-1:]).  Scalars
    replicate."""
    from ..optim.adafactor import _Factored
    rep = PartitionSpec()
    if hasattr(opt_shapes, "mu"):          # AdamW OptState
        return type(opt_shapes)(step=rep, mu=params_shardings,
                                nu=params_shardings)
    if hasattr(opt_shapes, "second"):      # AdafactorState
        def factored(ps):
            spec = list(ps)
            nd = len(spec)
            row = PartitionSpec(*spec[:max(nd - 1, 0)])
            col = PartitionSpec(*(spec[:max(nd - 2, 0)] + [spec[nd - 1]]
                                  if nd >= 2 else []))
            return _Factored(row=row, col=col)

        second = _tree.map(
            lambda leaf, ps: factored(ps) if isinstance(leaf, _Factored)
            else ps,
            opt_shapes.second, params_shardings,
            is_leaf=lambda t: isinstance(t, _Factored) or is_spec(t))
        return type(opt_shapes)(step=rep, second=second)
    raise TypeError(f"unknown optimizer state {type(opt_shapes)}")


# ---------------------------------------------------------------------------
# Specs → DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: PartitionSpec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that names tensor dim d, ``Replicate()`` on the others.  A
    tensor dim split over several mesh dims is split in mesh-dim order,
    outermost first, as the reference's tuple entries are."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(name)] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` under its spec of
    ``specs`` (a tree of the same structure).  Every rank passes the same
    full tensors (drawn from one seed) and keeps its shard."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        # every rank holds the full tensor: each keeps its shard, and no
        # rank's data is sent
        pl = placements(spec, mesh)
        d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        loc = d.to_local()
        if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
            # a dim-0 shard is a view of the full tensor: copy it, so the
            # full tensor is freed with the caller's last reference (and a
            # rank's memory holds only its shard)
            d = DTensor.from_local(loc.clone(), mesh, pl, run_check=False,
                                   shape=t.shape, stride=t.stride())
        return d
    return _tree.map(one, tree, specs, is_leaf=is_spec)


def shard_params(params, mesh, *, fsdp: bool = True,
                 moe_full_ep: bool = False):
    """``params`` (the same full tensors on every rank, e.g. drawn from one
    seed) as DTensors under :func:`param_shardings`."""
    return distribute(params, param_shardings(params, mesh, fsdp=fsdp,
                                              moe_full_ep=moe_full_ep), mesh)


def replicated(tree, mesh):
    """Each tensor of ``tree`` as a DTensor replicated over ``mesh`` (the
    sharded forward's decode caches)."""
    return distribute(tree, _tree.map(lambda t: PartitionSpec(), tree), mesh)


def local_nbytes(t) -> int:
    """Bytes of memory this rank's part of ``t`` keeps alive: the storage
    under its DTensor shard (a view of a larger tensor would count it
    all), or a plain tensor's."""
    from ..parallel.ops import is_dtensor
    loc = t.to_local() if is_dtensor(t) else t
    return loc.untyped_storage().nbytes()
