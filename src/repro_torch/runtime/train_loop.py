"""Training loop and the train-step factory — the port of
``repro.runtime.train_loop``.

``make_train_step`` builds the (params, opt, batch) → (params, opt,
metrics) function:

* cross-entropy over the padded-vocab logits (labels never hit pad ids);
* optional MTP auxiliary loss (DeepSeek): 0.1 × the nll of labels shifted
  one extra step;
* gradient accumulation: the global batch is split into
  ``n_microbatches`` contiguous row blocks (the reference's reshape; under
  a mesh, blocks of each data-parallel shard's rows), the
  gradients accumulated in ``acc_dtype`` (float32) and cast back to each
  parameter's dtype after the division;
* AdamW or Adafactor update with the cosine schedule.

The step runs eagerly (autograd, no compilation); each repeat of the
block runs under the ``ModelCtx``'s remat policy.  ``TrainLoop`` adds the
operational shell: checkpoint/restore of (params, optimizer state) with
the data stream's state, on ``device`` (default ``cuda``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from .. import _tree
from ..checkpoint import CheckpointManager
from ..data import TokenStream
from ..device import resolve_device
from ..models import ArchConfig, ModelCtx, model_fwd
from ..optim import (adafactor_update, adamw_init, adamw_update,
                     cosine_warmup)
from ..parallel.ops import is_dtensor, replicating, token_nll

__all__ = ["TrainLoopConfig", "TrainLoop", "make_train_step", "loss_fn",
           "value_and_grad"]


def loss_fn(params, batch: Dict[str, torch.Tensor], *, cfg: ArchConfig,
            ctx: ModelCtx = ModelCtx()) -> torch.Tensor:
    out = model_fwd(params, batch, cfg=cfg, ctx=ctx)
    labels = batch["labels"]
    nll = token_nll(out["logits"], labels)
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if cfg.mtp and "mtp_logits" in out:
        # predict t+2: shift labels one extra step
        l2 = torch.cat([labels[:, 1:], labels[:, -1:]], dim=1)
        loss = loss + 0.1 * token_nll(out["mtp_logits"], l2).mean()
    return loss


def value_and_grad(params, batch, *, cfg: ArchConfig,
                   ctx: ModelCtx = ModelCtx()):
    """(loss, grads): ``loss_fn`` and its gradient tree (each leaf in its
    parameter's dtype), as ``jax.value_and_grad`` gives them."""
    leaves, skeleton = _tree.flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    # under a mesh the backward, like the forward, meets the plain tensors
    # the forward built (masks, positions) beside DTensors
    with torch.enable_grad(), replicating() if ctx.mesh is not None \
            else contextlib.nullcontext():
        loss = loss_fn(_tree.unflatten(skeleton, live), batch, cfg=cfg,
                       ctx=ctx)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _tree.unflatten(skeleton, grads)


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of ``v``'s rows: block i of the rows of
    each data-parallel shard (a DTensor's row shards stay on their ranks);
    on one device, block i of all rows (the reference's reshape)."""
    dp = 1
    if is_dtensor(v):
        dp = math.prod(v.device_mesh.size(d) for d, p in
                       enumerate(v.placements) if p.is_shard(0))
    B, rest = v.shape[0], tuple(v.shape[1:])
    return v.reshape((dp, n, B // (dp * n)) + rest)[:, i].reshape(
        (B // n,) + rest)


def make_train_step(cfg: ArchConfig, *, ctx: ModelCtx = ModelCtx(),
                    n_microbatches: int = 1,
                    lr_peak: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000,
                    opt_state_dtype: Optional[str] = None,
                    acc_dtype: str = "float32",
                    optimizer: str = "adamw",
                    ) -> Callable:
    """Build train_step(params, opt_state, batch) → (params, opt, metrics).

    With ``n_microbatches > 1`` every array in ``batch`` is split along
    its leading axis into ``n_microbatches`` contiguous blocks (of each
    data-parallel shard's rows under a mesh), and the
    gradients are accumulated in ``acc_dtype``.  ``opt_state_dtype`` is
    accepted and unused, as in the reference: the state's dtype is the
    one its ``adamw_init`` chose."""
    schedule = cosine_warmup(lr_peak, warmup, total_steps)
    acc_dt = getattr(torch, acc_dtype)

    def single(params, mb):
        return value_and_grad(params, mb, cfg=cfg, ctx=ctx)

    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            loss, grads = single(params, batch)
        else:
            def mb_at(i):
                return {k: _microbatch(v, i, n_microbatches)
                        for k, v in batch.items()}
            p_leaves, skeleton = _tree.flatten(params)
            # shaped and placed as each parameter (a DTensor's shards)
            acc = [torch.zeros_like(p, dtype=acc_dt) for p in p_leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=p_leaves[0].device)
            for i in range(n_microbatches):
                l_i, g = single(params, mb_at(i))
                for a, gi in zip(acc, _tree.leaves(g)):
                    a.add_(gi)
                loss = loss + l_i
                del g
            loss = loss / n_microbatches
            grads = _tree.unflatten(skeleton, [
                (a / n_microbatches).to(p.dtype)
                for a, p in zip(acc, p_leaves)])
        if optimizer == "adafactor":
            new_params, new_opt = adafactor_update(params, grads, opt_state,
                                                   lr=schedule)
        else:
            new_params, new_opt = adamw_update(params, grads, opt_state,
                                               lr=schedule)
        metrics = {"loss": loss, "step": new_opt.step,
                   "lr": schedule(new_opt.step)}
        return new_params, new_opt, metrics

    return train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 300
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep: int = 2
    n_microbatches: int = 1
    lr_peak: float = 3e-4
    warmup: int = 50


class TrainLoop:
    """Operational training shell with checkpoint/restart, on ``device``
    (default ``cuda``; raises without a card unless the caller names the
    CPU)."""

    def __init__(self, cfg: ArchConfig, loop_cfg: TrainLoopConfig,
                 stream: TokenStream, *, ctx: ModelCtx = ModelCtx(),
                 rng_seed: int = 0,
                 extra_feats: Optional[dict] = None, device=None):
        from ..models import init_model
        self.device = resolve_device(device)
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.stream = stream
        self.ctx = ctx
        self.extra_feats = {k: torch.as_tensor(v, device=self.device)
                            for k, v in (extra_feats or {}).items()}
        self.params = init_model(rng_seed, cfg, self.device)
        self.opt_state = adamw_init(self.params)
        self.step = 0
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
        self._train_step = make_train_step(
            cfg, ctx=ctx, n_microbatches=loop_cfg.n_microbatches,
            lr_peak=loop_cfg.lr_peak, warmup=loop_cfg.warmup,
            total_steps=loop_cfg.total_steps)

    # -- fault tolerance -----------------------------------------------------

    def try_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        (self.params, self.opt_state), _, extra = self.ckpt.restore(
            (self.params, self.opt_state), step=latest)
        self.step = extra["data_state"]["step"]
        self.stream = TokenStream.from_state(
            extra["data_state"], self.stream.vocab, self.stream.seq_len,
            self.stream.global_batch)
        return True

    def save(self):
        self.ckpt.save(self.step, (self.params, self.opt_state),
                       extra={"data_state": self.stream.state(self.step)})

    # -- main loop -------------------------------------------------------------

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The stream's batch of ``step`` (int32 tokens and labels) and
        the static features, on the loop's device."""
        raw = self.stream.batch(step)
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in raw.items()}
        batch.update(self.extra_feats)
        return batch

    def run(self, callback: Optional[Callable[[int, dict], None]] = None,
            ) -> list:
        history = []
        t0 = time.time()
        while self.step < self.loop_cfg.total_steps:
            self.params, self.opt_state, metrics = self._train_step(
                self.params, self.opt_state, self.batch(self.step))
            self.step += 1
            if self.step % self.loop_cfg.log_every == 0 or \
                    self.step == self.loop_cfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["wall_s"] = time.time() - t0
                history.append((self.step, m))
                if callback:
                    callback(self.step, m)
            if self.step % self.loop_cfg.ckpt_every == 0:
                self.save()
        self.save()
        return history
