"""MDS-coded gradient aggregation — the port of
``repro.runtime.coded_grads``.

The data-parallel gradient sum  g = Σ_n g_n  is a row-separable linear
map of the per-group gradients, so the paper's row coding applies: stack
the k group gradients as the rows of X (k, D), encode with the
systematic generator G = [I; R], and the aggregator reconstructs the
full-batch gradient from **any** k of the n coded rows.

The encode is ``ops.mds_encode(G, X, systematic=True)``: on the card the
hand-written encode kernel (``csrc/mds_encode_gemm.cu``, float32 route)
copies the systematic rows and multiplies only the parity rows.  The
decode is a k × k float32 solve, as the reference's, here for the weights
that combine the arrived rows into the sum, applied over column chunks
(each column is independent, so the chunking bounds the memory and
changes no result).  ``compress_int8`` quantizes the arrived
rows as the reference does: a symmetric per-row scale over all of the
row's columns, round-half-to-even.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _tree
from ..core import mds
from ..kernels import ops

__all__ = ["encode_grad_shards", "coded_grad_aggregate", "flatten_grads"]

#: columns of the arrived rows one solve takes
CHUNK_COLS = 1 << 24


def flatten_grads(grad_trees: Sequence) -> tuple:
    """The k gradient trees as the rows of one float32 matrix X (k, D) on
    the first leaf's device (leaves in ``jax.tree`` order, each row
    written in place), with the tree's skeleton and leaf shapes."""
    flat = [_tree.flatten(g) for g in grad_trees]
    leaves0, skeleton = flat[0]
    shapes = [tuple(t.shape) for t in leaves0]
    D = sum(t.numel() for t in leaves0)
    X = torch.empty((len(flat), D), dtype=torch.float32,
                    device=leaves0[0].device)
    for row, (lv, _) in zip(X, flat):
        off = 0
        for t in lv:
            row[off:off + t.numel()].copy_(t.reshape(-1))
            off += t.numel()
    return X, skeleton, shapes


def _unflatten(flat: torch.Tensor, skeleton, shapes):
    out, off = [], 0
    for s in shapes:
        n = int(np.prod(s)) if s else 1
        out.append(flat[off:off + n].reshape(s))
        off += n
    return _tree.unflatten(skeleton, out)


def encode_grad_shards(grad_trees: Sequence, n_coded: int,
                       rng: np.random.Generator | int = 0):
    """Encode k per-group gradients into n_coded ≥ k shards.

    Returns (coded (n_coded, D) float32 matrix, decode context).  The
    first k rows are systematic (the originals, bit for bit)."""
    X, skeleton, shapes = flatten_grads(grad_trees)
    k = X.shape[0]
    G = torch.from_numpy(mds.make_generator(
        k, n_coded, kind="systematic", rng=rng, dtype=np.float32)).to(
        X.device)
    coded = ops.mds_encode(G, X, systematic=True)
    return coded, {"G": G, "treedef": skeleton, "shapes": shapes, "k": k}


def coded_grad_aggregate(coded: torch.Tensor, ctx: dict,
                         arrived: Sequence[int], *,
                         compress_int8: bool = False):
    """Reconstruct the *sum* of the k group gradients from any k arrived
    coded shards.  Returns the aggregated gradient tree (float32).

    The reference solves G_s X̂ = Y for the k shards X̂ and sums them; the
    sum alone is 1ᵀ G_s⁻¹ Y = wᵀ Y with G_sᵀ w = 1, so one k × k solve
    gives the weights w and the arrived rows are combined column chunk by
    column chunk of ``CHUNK_COLS`` (a solve with D right-hand sides took
    ~0.8 s a chunk of 2^24 columns on the card)."""
    k = ctx["k"]
    arrived = list(arrived)[:k]
    if len(arrived) < k:
        raise ValueError(f"need {k} shards, got {len(arrived)}")
    rows = torch.as_tensor(arrived, device=coded.device)
    Gs = ctx["G"][rows]                                  # (k, k)
    w = torch.linalg.solve(Gs.T, torch.ones((k, 1), dtype=Gs.dtype,
                                             device=Gs.device))   # (k, 1)
    if compress_int8:
        scale = torch.stack([coded[r].abs().amax() for r in arrived]
                            )[:, None] / 127.0            # (k, 1)
    D, step = coded.shape[1], CHUNK_COLS
    total = torch.empty((D,), dtype=torch.float32, device=coded.device)
    for c0 in range(0, D, step):
        Y = coded[rows, c0:c0 + step]                    # (k, w)
        if compress_int8:
            Y = torch.round(Y / torch.clamp(scale, min=1e-30)).to(torch.int8)
            Y = Y.to(torch.float32) * scale
        total[c0:c0 + step] = (w * Y).sum(dim=0)
    return _unflatten(total, ctx["treedef"], ctx["shapes"])
