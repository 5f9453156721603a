"""Step factories shared by the dry-run and the real launchers, and the
allocation-free model state — the port of ``repro.launch.steps``."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import _tree
from ..models import ArchConfig, ModelCtx, decode_step, init_model, prefill
from ..optim import adafactor_init, adamw_init
from ..runtime.train_loop import make_train_step

__all__ = ["build_train_fn", "build_prefill_fn", "build_decode_fn",
           "model_state_shapes"]


def model_state_shapes(cfg: ArchConfig, *, opt_state_dtype: Optional[str],
                       optimizer: str = "adamw", device="cuda",
                       fake_mode=None):
    """(params, opt_state) as fake tensors of ``fake_mode`` (a new
    ``FakeTensorMode`` when None) on ``device``: the reference's tree,
    shapes and dtypes, nothing allocated.

    ``init_model`` draws on a generator of its own device, and refuses a
    CUDA device without a card; so the parameters are drawn fake on the
    CPU and stood in for on ``device`` by factory calls."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode() if fake_mode is None else fake_mode
    dev = torch.device(device)
    with fake_mode:
        params = init_model(0, cfg, device="cpu")
        if dev.type != "cpu":
            params = _tree.map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=dev), params)
        if optimizer == "adafactor":
            opt = adafactor_init(params)
        else:
            opt = adamw_init(params, state_dtype=opt_state_dtype)
    return params, opt


def build_train_fn(cfg: ArchConfig, ctx: ModelCtx, n_microbatches: int,
                   opt_state_dtype: Optional[str] = "bfloat16",
                   acc_dtype: str = "float32",
                   optimizer: str = "adamw") -> Callable:
    step = make_train_step(cfg, ctx=ctx, n_microbatches=n_microbatches,
                           opt_state_dtype=opt_state_dtype,
                           acc_dtype=acc_dtype, optimizer=optimizer)

    def train_fn(params, opt_state, batch):
        return step(params, opt_state, batch)
    return train_fn


def build_prefill_fn(cfg: ArchConfig, ctx: ModelCtx) -> Callable:
    def prefill_fn(params, batch, caches):
        return prefill(params, batch, caches, cfg=cfg, ctx=ctx)
    return prefill_fn


def build_decode_fn(cfg: ArchConfig, ctx: ModelCtx) -> Callable:
    def decode_fn(params, tokens, pos, caches, enc_out=None):
        return decode_step(params, tokens, pos, caches, cfg=cfg, ctx=ctx,
                           enc_out=enc_out)
    return decode_fn
