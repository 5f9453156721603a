"""Composable LM stack — the port of ``repro.models.lm``: decoder-only,
encoder-decoder, hybrid (attention + Mamba), RWKV-6.

A model = embeddings + ``prefix`` (a list of unrolled layers) +
``n_repeats`` copies of the repeating ``block`` (parameters stacked on a
leading axis, as in the reference, walked by a Python loop instead of
``lax.scan``) + final norm + output head.  Modality frontends are stub
projections of precomputed features, as in the reference: an audio
encoder-decoder takes ``enc_feats``, a vision model prepends projected
``patch_feats`` in ``model_fwd`` (the reference's ``prefill`` has no
vision branch, so serving is text-only).  DeepSeek's MTP head adds
``mtp_logits`` to the full forward.

Three entry points, as in the reference:
  * ``model_fwd``    — full-sequence forward
  * ``prefill``      — full-sequence forward that also fills a decode cache
  * ``decode_step``  — one token with cache (serving)

Parameters are plain nested dicts (and the prefix's list) of tensors with
the reference's tree layout and dtypes, so
:func:`repro_torch.convert.params_from_numpy` carries the reference's
parameters across for the tests.  :func:`init_model` draws its own from a
seeded ``torch.Generator`` with the reference's shapes, dtypes and scales
(the values differ: the two frameworks' generators differ).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from . import attention as attn
from . import layers as ly
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .config import ArchConfig
from ..device import resolve_device

__all__ = ["init_model", "model_fwd", "prefill", "decode_step",
           "init_cache_shapes", "padded_vocab", "torch_dtype"]


def padded_vocab(cfg: ArchConfig, mult: int = 512) -> int:
    return -(-cfg.vocab // mult) * mult


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec, dtype,
                device, cross: bool = False) -> dict:
    p = {"norm1": ly.init_rms(cfg.d_model, dtype, device),
         "norm2": ly.init_rms(cfg.d_model, dtype, device)}
    if spec.mixer == "attn":
        init = attn.init_mla if cfg.mla is not None else attn.init_gqa
        p["mixer"] = init(gen, cfg, dtype, device)
    elif spec.mixer == "mamba":
        p["mixer"] = ssm_mod.init_mamba(gen, cfg, dtype, device)
    elif spec.mixer == "rwkv":
        p["mixer"] = rwkv_mod.init_rwkv_tmix(gen, cfg, dtype, device)
    if cross:
        p["norm_x"] = ly.init_rms(cfg.d_model, dtype, device)
        p["cross"] = attn.init_cross(gen, cfg, dtype, device)
    if spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, cfg, dtype, device)
    elif spec.mixer == "rwkv":
        # the layer spec's ffn field is unused: the channel-mix replaces it
        p["ffn"] = rwkv_mod.init_rwkv_cmix(gen, cfg, dtype, device)
    else:
        p["ffn"] = ly.init_ffn(gen, cfg.d_model, cfg.d_ff, spec.ffn, dtype,
                               device)
    return p


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_blocks(gen, cfg: ArchConfig, specs, n_repeats: int, dt, dev,
                 cross: bool = False) -> dict:
    """The ``n_repeats`` copies of each layer of ``specs``, stacked on a
    leading axis."""
    return {f"layer{i}": _stack([_init_layer(gen, cfg, spec, dt, dev, cross)
                                 for _ in range(n_repeats)])
            for i, spec in enumerate(specs)}


def init_model(seed: int, cfg: ArchConfig, device=None) -> dict:
    """Seeded parameters with the reference's tree, shapes, dtypes and
    scales, drawn on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    cfg_p = dataclasses.replace(cfg, vocab=padded_vocab(cfg))
    params: Dict[str, Any] = {
        "embed": ly.init_embedding(gen, cfg_p, dt, dev)}
    if cfg.prefix:
        params["prefix"] = [_init_layer(gen, cfg, s, dt, dev)
                            for s in cfg.prefix]
    # an encoder-decoder's decoder blocks carry cross-attention
    params["blocks"] = _init_blocks(gen, cfg, cfg.block, cfg.n_repeats, dt,
                                    dev, cross=cfg.enc_dec)
    params["final_norm"] = ly.init_rms(cfg.d_model, dt, dev)
    if cfg.enc_dec:
        params["enc_blocks"] = _init_blocks(gen, cfg, cfg.enc_block,
                                            cfg.n_enc_repeats, dt, dev)
        params["enc_norm"] = ly.init_rms(cfg.d_model, dt, dev)
    if cfg.frontend is not None:
        params["frontend"] = {"proj": ly._normal(
            gen, (cfg.frontend_dim, cfg.d_model), dt, dev)
            / cfg.frontend_dim ** 0.5}
    if cfg.mtp:
        params["mtp"] = {
            "norm": ly.init_rms(cfg.d_model, dt, dev),
            "proj": ly._normal(gen, (2 * cfg.d_model, cfg.d_model), dt, dev)
            / (2.0 * cfg.d_model) ** 0.5}
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
                 cache=None, enc_out=None):
    h = ly.rms_norm(x, p["norm1"], cfg.norm_eps)
    mixer_cache = cache.get("mixer") if cache else None
    if spec.mixer == "attn":
        base = cfg.rope_base_local if spec.sliding_window else cfg.rope_base
        if cfg.mla is not None:
            mo, new_mc = attn.apply_mla(p["mixer"], h, cfg=cfg,
                                        rope_base=base, positions=positions,
                                        cache=mixer_cache)
        else:
            mo, new_mc = attn.apply_gqa(p["mixer"], h, cfg=cfg,
                                        window=spec.sliding_window,
                                        rope_base=base, positions=positions,
                                        cache=mixer_cache)
    elif spec.mixer == "mamba":
        mo, new_mc = ssm_mod.apply_mamba(p["mixer"], h, cfg=cfg,
                                         cache=mixer_cache)
    elif spec.mixer == "rwkv":
        mo, new_mc = rwkv_mod.apply_rwkv_tmix(p["mixer"], h, cfg=cfg,
                                              cache=mixer_cache)
    else:
        raise ValueError(spec.mixer)
    x = x + mo

    if "cross" in p and enc_out is not None:
        hx = ly.rms_norm(x, p["norm_x"], cfg.norm_eps)
        x = x + attn.apply_cross(p["cross"], hx, enc_out, cfg=cfg)

    h2 = ly.rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.ffn == "moe":
        fo = moe_mod.apply_moe(p["ffn"], h2, cfg=cfg)
    elif spec.mixer == "rwkv":
        # the channel-mix carries its token shift in the time-mix's cache
        fo, new_mc = rwkv_mod.apply_rwkv_cmix(p["ffn"], h2, cache=new_mc)
    else:
        fo = ly.apply_ffn(p["ffn"], h2, spec.ffn)
    return x + fo, new_mc


def _store(cache: Optional[dict], new_mc: Optional[dict]) -> None:
    """Write a layer's new mixer cache into its (view of the) cache tree;
    leaves a mixer updated in place are skipped."""
    if new_mc is None:
        return
    mc = cache["mixer"]
    for k, v in new_mc.items():
        if v is not mc[k]:
            mc[k].copy_(v)


def _run_blocks(blocks, x, *, cfg: ArchConfig, specs, n_repeats: int,
                positions=None, caches=None, enc_out=None):
    for r in range(n_repeats):
        for i, spec in enumerate(specs):
            name = f"layer{i}"
            c = _at(caches[name], r) if caches is not None else None
            x, new_mc = _apply_layer(_at(blocks[name], r), x, cfg=cfg,
                                     spec=spec, positions=positions,
                                     cache=c, enc_out=enc_out)
            if c is not None:
                _store(c, new_mc)
    return x


def _trunk(params, x, *, cfg: ArchConfig, positions, caches=None,
           enc_out=None):
    """The prefix layers, the repeated blocks, the final norm.  Every
    cache leaf updates in place."""
    if cfg.prefix:
        pc = caches.get("prefix") if caches else None
        for i, spec in enumerate(cfg.prefix):
            c = pc[i] if pc is not None else None
            x, new_mc = _apply_layer(params["prefix"][i], x, cfg=cfg,
                                     spec=spec, positions=positions,
                                     cache=c, enc_out=enc_out)
            if c is not None:
                _store(c, new_mc)
    x = _run_blocks(params["blocks"], x, cfg=cfg, specs=cfg.block,
                    n_repeats=cfg.n_repeats, positions=positions,
                    caches=caches.get("blocks") if caches else None,
                    enc_out=enc_out)
    return ly.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(params, x, cfg: ArchConfig):
    return ly.logits(params["embed"], x,
                     dataclasses.replace(cfg, vocab=padded_vocab(cfg)))


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _encoder(params, feats, *, cfg: ArchConfig):
    x = ly.einsum("btf,fd->btd", feats, params["frontend"]["proj"])
    x = _run_blocks(params["enc_blocks"], x, cfg=cfg, specs=cfg.enc_block,
                    n_repeats=cfg.n_enc_repeats)
    return ly.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device).expand(B, T)


def model_fwd(params, batch: Dict[str, torch.Tensor], *,
              cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Full-sequence forward.  Returns {"logits", optional "mtp_logits"}.

    batch: tokens (B, T); audio/enc feats (B, Ts, F) for enc-dec; patch
    feats (B, P, F) for VLM prefix conditioning."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = ly.embed(params["embed"], tokens)
    enc_out = None
    n_prefix_tokens = 0
    if cfg.enc_dec:
        enc_out = _encoder(params, batch["enc_feats"], cfg=cfg)
    elif cfg.frontend == "vision":
        pre = ly.einsum("bpf,fd->bpd", batch["patch_feats"],
                        params["frontend"]["proj"])
        n_prefix_tokens = pre.shape[1]
        x = torch.cat(ly.promote(pre, x), dim=1)
    x = _trunk(params, x, cfg=cfg,
               positions=_positions(B, x.shape[1], tokens.device),
               enc_out=enc_out)
    if n_prefix_tokens:
        x = x[:, n_prefix_tokens:]
    out = {"logits": _head(params, x, cfg)}
    if cfg.mtp:
        nxt = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
        h = torch.cat([ly.rms_norm(x, params["mtp"]["norm"], cfg.norm_eps),
                       nxt], dim=-1)
        h = ly.einsum("bte,ed->btd", h, params["mtp"]["proj"])
        out["mtp_logits"] = _head(params, h, cfg)
    return out


def init_cache_shapes(cfg: ArchConfig, batch: int, max_len: int
                      ) -> Dict[str, Any]:
    """Cache template: ``(shape, dtype)`` leaves in the reference's tree
    (the prefix's a list, the blocks' stacked on the leading
    ``n_repeats`` axis)."""
    dt = torch_dtype(cfg)

    def layer_cache(spec):
        if spec.mixer == "attn":
            if cfg.mla is not None:
                return {"mixer": attn.mla_cache_spec(cfg, batch, max_len,
                                                     dt)}
            return {"mixer": attn.gqa_cache_spec(cfg, batch, max_len,
                                                 spec.sliding_window, dt)}
        if spec.mixer == "mamba":
            return {"mixer": ssm_mod.mamba_cache_spec(cfg, batch, dt)}
        if spec.mixer == "rwkv":
            return {"mixer": rwkv_mod.rwkv_cache_spec(cfg, batch, dt)}
        return {}

    def stacked(spec):
        return {k: {n: ((cfg.n_repeats,) + s, d) for n, (s, d) in v.items()}
                for k, v in layer_cache(spec).items()}

    caches: Dict[str, Any] = {}
    if cfg.prefix:
        caches["prefix"] = [layer_cache(s) for s in cfg.prefix]
    caches["blocks"] = {f"layer{i}": stacked(s)
                        for i, s in enumerate(cfg.block)}
    return caches


def prefill(params, batch, caches, *, cfg: ArchConfig,
            return_hidden: bool = False):
    """Process the prompt, fill the cache, return last-position logits.

    batch: tokens (B, T), and enc feats (B, Ts, F) for enc-dec (the
    encoder output is not returned, as in the reference).
    ``return_hidden`` additionally returns the final-norm hidden state of
    the last position (B, 1, d_model) — the input of the output-head
    matmul, which coded serving executes as a distributed MDS-coded
    product instead of the local head contraction."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = ly.embed(params["embed"], tokens)
    enc_out = _encoder(params, batch["enc_feats"], cfg=cfg) \
        if cfg.enc_dec else None
    x = _trunk(params, x, cfg=cfg, positions=_positions(B, T, tokens.device),
               caches=caches, enc_out=enc_out)
    hidden = x[:, -1:]
    result = (_head(params, hidden, cfg), caches)
    if return_hidden:
        result += (hidden,)
    return result


def decode_step(params, tokens, pos, caches, *, cfg: ArchConfig,
                enc_out=None, return_hidden: bool = False):
    """One decode step.  tokens (B, 1), pos (B,) absolute positions;
    ``enc_out`` (B, Ts, d) feeds an encoder-decoder's cross-attention
    (without it the step skips cross-attention, as the reference's serving
    loop does).

    ``return_hidden`` additionally returns the final-norm hidden state
    (B, 1, d_model) feeding the output head."""
    x = ly.embed(params["embed"], tokens)
    x = _trunk(params, x, cfg=cfg, positions=pos[:, None], caches=caches,
               enc_out=enc_out)
    result = (_head(params, x, cfg), caches)
    if return_hidden:
        result += (x,)
    return result
