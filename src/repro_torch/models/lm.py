"""Decoder LM stack — the port of the dense-GQA and RWKV-6 paths of
``repro.models.lm``.

A model = embeddings + ``n_repeats`` copies of the repeating ``block``
(parameters stacked on a leading axis, as in the reference, walked by a
Python loop instead of ``lax.scan``) + final norm + output head.

Three entry points, as in the reference:
  * ``model_fwd``    — full-sequence forward
  * ``prefill``      — full-sequence forward that also fills a decode cache
  * ``decode_step``  — one token with cache (serving)

Parameters are plain nested dicts of tensors with the reference's tree
layout, so :func:`repro_torch.convert.params_from_numpy` carries the
reference's parameters across for the tests.  :func:`init_model` draws
its own from a seeded ``torch.Generator`` with the reference's shapes,
dtypes and scales (the values differ: the two frameworks' generators
differ).  Two kinds of stack run here: dense decoders of global-attention
GQA layers with dense FFNs, and RWKV-6 stacks (time-mix + channel-mix,
:mod:`.rwkv`, whose WKV runs through the hand-written kernel).  MoE, MLA,
Mamba, sliding windows, prefix layers, encoder-decoder stacks and
modality frontends raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import attention as attn
from . import layers as ly
from . import rwkv as rwkv_mod
from .config import ArchConfig
from ..device import resolve_device

__all__ = ["init_model", "model_fwd", "prefill", "decode_step",
           "init_cache_shapes", "padded_vocab", "torch_dtype",
           "check_supported"]


def padded_vocab(cfg: ArchConfig, mult: int = 512) -> int:
    return -(-cfg.vocab // mult) * mult


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    dense = all(s.mixer == "attn" and s.ffn in ("swiglu", "gelu", "relu2")
                and s.sliding_window is None for s in cfg.block)
    rwkv = all(s.mixer == "rwkv" for s in cfg.block)
    if (not (dense or rwkv) or cfg.prefix or cfg.mla is not None
            or cfg.enc_dec or cfg.frontend is not None or cfg.mtp):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense global-attention GQA decoders "
            "and RWKV-6 stacks only; MoE, MLA, Mamba, sliding windows, "
            "prefix layers, encoder-decoder and frontends come with the "
            "remaining-mixers slice")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec, dtype,
                device) -> dict:
    p = {"norm1": ly.init_rms(cfg.d_model, dtype, device),
         "norm2": ly.init_rms(cfg.d_model, dtype, device)}
    if spec.mixer == "rwkv":
        # the layer spec's ffn field is unused: the channel-mix replaces it
        p["mixer"] = rwkv_mod.init_rwkv_tmix(gen, cfg, dtype, device)
        p["ffn"] = rwkv_mod.init_rwkv_cmix(gen, cfg, dtype, device)
    else:
        p["mixer"] = attn.init_gqa(gen, cfg, dtype, device)
        p["ffn"] = ly.init_ffn(gen, cfg.d_model, cfg.d_ff, spec.ffn, dtype,
                               device)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_model(seed: int, cfg: ArchConfig, device=None) -> dict:
    """Seeded parameters with the reference's tree, shapes, dtypes and
    scales, drawn on ``device`` (default ``cuda``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    cfg_p = dataclasses.replace(cfg, vocab=padded_vocab(cfg))
    params: Dict[str, Any] = {
        "embed": ly.init_embedding(gen, cfg_p, dt, dev)}
    params["blocks"] = {
        f"layer{i}": _stack([_init_layer(gen, cfg, spec, dt, dev)
                             for _ in range(cfg.n_repeats)])
        for i, spec in enumerate(cfg.block)}
    params["final_norm"] = ly.init_rms(cfg.d_model, dt, dev)
    return params


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _at(tree, r: int):
    """Repeat ``r`` of a stacked parameter/cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


def _apply_layer(p: dict, x, *, cfg: ArchConfig, spec, positions=None,
                 cache=None):
    h = ly.rms_norm(x, p["norm1"], cfg.norm_eps)
    mixer_cache = cache.get("mixer") if cache else None
    if spec.mixer == "rwkv":
        mo, new_mc = rwkv_mod.apply_rwkv_tmix(p["mixer"], h, cfg=cfg,
                                              cache=mixer_cache)
    else:
        mo, new_mc = attn.apply_gqa(p["mixer"], h, cfg=cfg,
                                    rope_base=cfg.rope_base,
                                    positions=positions, cache=mixer_cache)
    x = x + mo
    h2 = ly.rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.mixer == "rwkv":
        # the channel-mix carries its token shift in the time-mix's cache
        fo, new_mc = rwkv_mod.apply_rwkv_cmix(p["ffn"], h2, cache=new_mc)
    else:
        fo = ly.apply_ffn(p["ffn"], h2, spec.ffn)
    return x + fo, new_mc


def _trunk(params, x, *, cfg: ArchConfig, positions, caches=None):
    """The repeated blocks + final norm.  Caches update in place."""
    blocks = caches.get("blocks") if caches else None
    for r in range(cfg.n_repeats):
        for i, spec in enumerate(cfg.block):
            name = f"layer{i}"
            c = _at(blocks[name], r) if blocks is not None else None
            x, new_mc = _apply_layer(_at(params["blocks"][name], r), x,
                                     cfg=cfg, spec=spec, positions=positions,
                                     cache=c)
            if new_mc is None:
                continue
            mc = blocks[name]["mixer"]
            if spec.mixer == "rwkv":
                for leaf in ("wkv", "shift_t", "shift_c"):
                    mc[leaf][r].copy_(new_mc[leaf])
            else:
                mc["len"][r] = new_mc["len"]
    return ly.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(params, x, cfg: ArchConfig):
    return ly.logits(params["embed"], x,
                     dataclasses.replace(cfg, vocab=padded_vocab(cfg)))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def model_fwd(params, batch: Dict[str, torch.Tensor], *,
              cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Full-sequence forward.  Returns {"logits"}; batch: tokens (B, T)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = ly.embed(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = _trunk(params, x, cfg=cfg, positions=positions)
    return {"logits": _head(params, x, cfg)}


def init_cache_shapes(cfg: ArchConfig, batch: int, max_len: int
                      ) -> Dict[str, Any]:
    """Cache template: ``(shape, dtype)`` leaves in the reference's tree
    (layer caches stacked on the leading ``n_repeats`` axis)."""
    check_supported(cfg)
    dt = torch_dtype(cfg)

    def stacked(spec):
        one = rwkv_mod.rwkv_cache_spec(cfg, batch, dt) \
            if spec.mixer == "rwkv" \
            else attn.gqa_cache_spec(cfg, batch, max_len, dt)
        return {"mixer": {k: ((cfg.n_repeats,) + s, d)
                          for k, (s, d) in one.items()}}

    return {"blocks": {f"layer{i}": stacked(s)
                       for i, s in enumerate(cfg.block)}}


def prefill(params, batch, caches, *, cfg: ArchConfig,
            return_hidden: bool = False):
    """Process the prompt, fill the cache, return last-position logits.

    ``return_hidden`` additionally returns the final-norm hidden state of
    the last position (B, 1, d_model) — the input of the output-head
    matmul, which coded serving executes as a distributed MDS-coded
    product instead of the local head contraction."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = ly.embed(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = _trunk(params, x, cfg=cfg, positions=positions, caches=caches)
    hidden = x[:, -1:]
    result = (_head(params, hidden, cfg), caches)
    if return_hidden:
        result += (hidden,)
    return result


def decode_step(params, tokens, pos, caches, *, cfg: ArchConfig,
                return_hidden: bool = False):
    """One decode step.  tokens (B, 1), pos (B,) absolute positions.

    ``return_hidden`` additionally returns the final-norm hidden state
    (B, 1, d_model) feeding the output head."""
    x = ly.embed(params["embed"], tokens)
    x = _trunk(params, x, cfg=cfg, positions=pos[:, None], caches=caches)
    result = (_head(params, x, cfg), caches)
    if return_hidden:
        result += (x,)
    return result
