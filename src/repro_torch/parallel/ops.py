"""Sharding-aware primitive ops used inside the model — the port of
``repro.parallel.ops`` on ``torch.distributed``.

* ``sharded_embed`` — token embedding against a vocab-sharded table: a
  masked local take on each "model" rank, then a sum over the "model"
  dim (the standard TP embedding);
* ``token_nll`` — cross-entropy against (possibly vocab-sharded) logits;
* the mesh plumbing the sharded forward shares: a mesh dim's process
  group (:func:`group_of`), the data-parallel placements of an activation
  (:func:`data_placements`), FSDP's gather of a layer's weights on use
  (:func:`gather_on_use`), and the collectives the ``local_map`` bodies
  run on local tensors (:func:`psum`, :func:`all_to_all`,
  :func:`all_gather`).

Under a mesh the forward runs on DTensors (``torch.distributed.tensor``):
the weights carry the placements of :mod:`repro_torch.parallel.sharding`,
the activations the batch's.  Ops with a DTensor sharding rule propagate
it; the port's kernels and the bodies the reference wrote under
``shard_map`` run under ``local_map`` on each rank's local tensors.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["sharded_embed", "token_nll", "is_dtensor", "replicating",
           "group_of",
           "data_placements", "gather_on_use", "settle", "per_head", "psum",
           "all_to_all", "all_gather", "EMBED_CALLS"]

#: sharded embeddings taken through the masked-take body (the tests and
#: the smoke run read it to show the path ran)
EMBED_CALLS = 0


@contextlib.contextmanager
def replicating():
    """DTensor's ``implicit_replication`` for the body of the ``with``,
    restored to what it was after (torch's own context turns it off on
    exit, also when nested in another): plain tensors built inside the
    forward (positions, masks) join DTensor ops as replicated."""
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    was = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = was


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def group_of(mesh, axes: Sequence[str]):
    """The process group spanning the mesh dims ``axes`` (one dim's group,
    or the flattened group of several, e.g. ("pod", "data"))."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    # the mesh's rank table is host bookkeeping: under a fake mode (the
    # dry-run's) it stays a real tensor
    with unset_fake_temporarily():
        return mesh[axes]._flatten().get_group()


def _backend(group) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(group))


class _Psum(torch.autograd.Function):
    """The all-reduce of :func:`psum` with its transpose.  The sum is
    replicated over the group, and ``local_map`` hands each rank the whole
    cotangent of a replicated output, so the transpose is the identity
    (the reference's ``psum`` under ``shard_map`` transposes to its
    broadcast)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        if _backend(group) == "gloo" and t.dtype not in (
                torch.float32, torch.float64, torch.int32, torch.int64):
            wide = t.float()
            dist.all_reduce(wide, group=group)
            return wide.to(t.dtype)
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (a new tensor; differentiable, its
    gradient the cotangent itself).  Gloo reduces no bfloat16 or float8:
    there the sum runs in float32 and is cast back."""
    return _Psum.apply(t, group)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(t, split_axis=0, concat_axis=0, tiled=False)``:
    block i of ``t``'s leading dim (one per rank) goes to rank i, and the
    result's block j came from rank j.  The payload moves as its bytes,
    so any dtype (bfloat16, float8) crosses any backend."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if t.shape[0] != n:
        raise ValueError(f"all_to_all: leading dim {t.shape[0]} != group "
                         f"size {n}")
    src = _bytes(t)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.view(t.dtype).reshape(t.shape)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated on dim 0 in rank order
    (``lax.all_gather(..., axis=0, tiled=True)``)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    src = _bytes(t)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=torch.uint8, device=t.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view(t.dtype).reshape((n * t.shape[0],) + tuple(t.shape[1:]))


def data_placements(mesh, model_axis: str, shard_dim: Optional[int]):
    """Placements (a list: ``local_map`` reads a tuple as one entry per
    output) of an activation: ``Shard(shard_dim)`` on every data dim
    (``Replicate()`` when ``shard_dim`` is None), ``Replicate()`` on the
    model dim."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if a == model_axis or shard_dim is None
            else Shard(shard_dim) for a in mesh.mesh_dim_names]


def settle(x, model_axis: str = "model"):
    """An activation DTensor (batch first) at the forward's canonical
    placements: the batch on the data dims when they hold more than one
    rank and it divides them, whole on the model dim (a partial sum over
    the model dim is reduced: the tensor-parallel all-reduce).  DTensor's
    rules pick the cheapest placement op by op; pinned at each layer's
    boundaries, no op meets a placement (a sharded size-1 dim, say) its
    reshape cannot take.  A plain tensor passes through."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    dp = 1
    for a in mesh.mesh_dim_names:
        if a != model_axis:
            dp *= mesh.size(mesh.mesh_dim_names.index(a))
    want = data_placements(mesh, model_axis,
                           0 if dp > 1 and x.shape[0] % dp == 0 else None)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def per_head(x, head_dim: Optional[int], *heads: int,
             model_axis: str = "model") -> list:
    """``local_map`` placements for a per-head computation on ``x``'s mesh:
    ``Shard(head_dim)`` on the model dim when it divides every count in
    ``heads`` (else, or with ``head_dim`` None, replicated), the batch
    (dim 0) sharded over the data dims as ``x``'s is."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    S = mesh.size(names.index(model_axis)) if model_axis in names else 1
    tp = head_dim is not None and all(h % S == 0 for h in heads)
    return [(Shard(head_dim) if tp else Replicate()) if a == model_axis
            else (p if isinstance(p, Shard) and p.dim == 0 else Replicate())
            for a, p in zip(names, x.placements)]


def _gather_leaf(t, model_axis: str):
    from torch.distributed.tensor import Replicate
    if not is_dtensor(t):
        return t
    names = t.device_mesh.mesh_dim_names
    want = tuple(p if names[i] == model_axis else Replicate()
                 for i, p in enumerate(t.placements))
    if want == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def gather_on_use(tree, model_axis: str = "model", skip: Tuple[str, ...] = ()):
    """A layer's weights with their FSDP (data-dim) shards gathered and
    their tensor-parallel (model-dim) shards kept — ZeRO-3's gather on
    use, which GSPMD inserts in the reference.  Plain tensors pass
    through; the keys of ``skip`` (a MoE layer's experts, which its
    ``local_map`` places itself) are left as they are."""
    if isinstance(tree, dict):
        return {k: v if k in skip else gather_on_use(v, model_axis)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_on_use(v, model_axis) for v in tree]
    return _gather_leaf(tree, model_axis)


def sharded_embed(table: torch.Tensor, tokens: torch.Tensor, mesh,
                  model_axis: str = "model",
                  data_axes: Optional[tuple] = None) -> torch.Tensor:
    """tokens (B, T) → (B, T, d) with table (V, d) sharded on V.

    Without a mesh, or when the model dim does not divide V, the plain
    gather."""
    if mesh is None or model_axis not in mesh.mesh_dim_names \
            or table.shape[0] % mesh.size(
                mesh.mesh_dim_names.index(model_axis)):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = mesh.mesh_dim_names
    S = mesh.size(names.index(model_axis))
    rows = table.shape[0] // S
    daxes = data_axes or tuple(a for a in names if a != model_axis)
    dp = 1
    for a in daxes:
        dp *= mesh.size(names.index(a))
    shardable = tokens.shape[0] % dp == 0 and dp > 1
    tok_pl = data_placements(mesh, model_axis, 0 if shardable else None)
    tab_pl = [Shard(0) if a == model_axis else Replicate() for a in names]
    group = mesh.get_group(model_axis)

    def emb(tab, tok):
        global EMBED_CALLS
        EMBED_CALLS += 1
        lo = mesh.get_local_rank(model_axis) * rows
        out = tab[(tok - lo).clamp(0, rows - 1)]
        ok = (tok >= lo) & (tok < lo + rows)
        # one rank holds each token's row: the sum adds only zeros to it
        return psum(out.masked_fill(~ok[..., None], 0), group)

    # each data rank takes its own rows of the batch: the table's local
    # gradient is that rank's part of the sum over the batch
    grad_pl = [Shard(0) if a == model_axis else Partial() for a in names]
    return local_map(emb, out_placements=tok_pl,
                     in_placements=(tab_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log p(labels) per token.

    logits (B, T, V) any dtype; labels (B, T) integer (int32 as the data
    pipeline gives them) → (B, T) float32.  The max is detached, as the
    reference's ``stop_gradient``; the label's logit is gathered (the
    reference's iota-compare sum picks the same value; vocab-sharded
    DTensor logits take that sum)."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    shifted = lg - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    if not (is_dtensor(lg) and any(p.is_shard(lg.ndim - 1)
                                   for p in lg.placements)):
        picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
        return lse - picked
    # vocab-sharded logits: a sharded gather has no working DTensor rule,
    # so the reference's iota compare, summed over the shards (one
    # nonzero term: the same value)
    with replicating():
        iota = torch.arange(lg.shape[-1], device=lg.device)
        hit = iota == labels.long()[..., None]
        picked = torch.where(hit, shifted, 0.0).sum(dim=-1)
    return lse - picked
