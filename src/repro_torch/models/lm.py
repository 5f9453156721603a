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
``mtp_logits`` to the full forward.  ``ModelCtx`` carries the training
forward's activation-checkpointing policy and the mesh.

Under a mesh (``ModelCtx.mesh``, a ``DeviceMesh`` over ("data", "model")
or ("pod", "data", "model")) the three entry points run on DTensors: the
parameters carry the placements of
:func:`repro_torch.parallel.sharding.param_shardings` (distributed with
:func:`~repro_torch.parallel.sharding.distribute`), the tokens the
batch's.  Each layer gathers its FSDP shards on use and keeps its
tensor-parallel ones (:func:`repro_torch.parallel.ops.gather_on_use`);
ops propagate their DTensor sharding rules, and the vocab-sharded
embedding, the MoE's expert-parallel bodies and the WKV kernel run under
``local_map``.  Decode caches are DTensors replicated over the mesh (a
cache write into a sharded cache has no in-place DTensor rule).  The
logits come back as a DTensor (``.full_tensor()`` gathers them).

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

import contextlib
import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as _ckpt

from . import attention as attn
from . import layers as ly
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .config import ArchConfig
from ..device import resolve_device
from ..parallel import ops as pops

__all__ = ["init_model", "model_fwd", "prefill", "decode_step",
           "init_cache_shapes", "padded_vocab", "torch_dtype", "ModelCtx"]


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Context threaded through the forward: the reference's fields (the
    remat policy first, so ``ModelCtx("dots")`` names it).

    ``mesh``: the DeviceMesh the forward is sharded over (None: one
    device); ``model_axis`` its tensor-parallel dim.  ``ep_full``: shard
    MoE experts over the data dims too (full-mesh expert parallelism;
    requires num_experts % dp == 0).  ``a2a_fp8``: float8 MoE dispatch
    payloads under ``ep_full``.

    ``remat_policy`` says what a training forward keeps of each repeat of
    the block for the backward: ``"full"`` recomputes the whole repeat
    (the reference's ``jax.checkpoint``), ``"dots"`` keeps the matmul
    outputs and recomputes the rest (its ``dots_with_no_batch_dims``
    policy), ``"none"`` keeps everything (no recomputation; the port's
    own option).  Remat applies only where autograd records and there
    are no caches; the gradients are the same under every policy."""
    remat_policy: str = "full"   # "full" | "dots" | "none"
    mesh: Optional[Any] = None
    model_axis: str = "model"
    ep_full: bool = False
    a2a_fp8: bool = False


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
                 cache=None, enc_out=None, ctx: ModelCtx = ModelCtx()):
    if ctx.mesh is not None:
        # FSDP: gather the data-dim shards on use; a MoE layer's experts
        # are placed by its expert-parallel body
        experts = ("w_in", "w_gate", "w_out") if spec.ffn == "moe" else ()
        p = {k: pops.gather_on_use(v, ctx.model_axis,
                                   skip=experts if k == "ffn" else ())
             for k, v in p.items()}
        x = pops.settle(x, ctx.model_axis)
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

    if ctx.mesh is not None:
        x = pops.settle(x, ctx.model_axis)
    h2 = ly.rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.ffn == "moe":
        fo = moe_mod.apply_moe(p["ffn"], h2, cfg=cfg, mesh=ctx.mesh,
                               model_axis=ctx.model_axis,
                               ep_full=ctx.ep_full, a2a_fp8=ctx.a2a_fp8)
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


#: the ops whose outputs the "dots" policy keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_saveable(_sac_ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, x, policy: str):
    """``fn(x)`` under activation checkpointing with ``policy``."""
    if policy == "full":
        return _ckpt.checkpoint(fn, x, use_reentrant=False)
    if policy == "dots":
        return _ckpt.checkpoint(
            fn, x, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_saveable))
    raise ValueError(f"unknown remat_policy {policy!r}")


def _run_blocks(blocks, x, *, cfg: ArchConfig, specs, n_repeats: int,
                positions=None, caches=None, enc_out=None,
                ctx: ModelCtx = ModelCtx(),
                hiddens: Optional[List[torch.Tensor]] = None):
    """The ``n_repeats`` repeats of ``specs``.  A training forward (grad
    mode on, no caches) runs each repeat under ``ctx.remat_policy``.
    ``hiddens``, when given, receives every layer's post-residual state
    in order (repeat by repeat, layer by layer)."""
    remat = caches is None and torch.is_grad_enabled() \
        and ctx.remat_policy != "none"

    def repeat(x, r):
        # a remat recompute runs in the backward, outside the forward's
        # scope: it enters the mesh's own
        with pops.replicating() if ctx.mesh is not None \
                else contextlib.nullcontext():
            return _repeat(x, r)

    def _repeat(x, r):
        for i, spec in enumerate(specs):
            name = f"layer{i}"
            c = _at(caches[name], r) if caches is not None else None
            x, new_mc = _apply_layer(_at(blocks[name], r), x, cfg=cfg,
                                     spec=spec, positions=positions,
                                     cache=c, enc_out=enc_out, ctx=ctx)
            if c is not None:
                _store(c, new_mc)
            if hiddens is not None:
                hiddens.append(x)
        return x

    for r in range(n_repeats):
        x = _remat(functools.partial(repeat, r=r), x, ctx.remat_policy) \
            if remat else repeat(x, r)
    return x


def _trunk(params, x, *, cfg: ArchConfig, positions, caches=None,
           enc_out=None, ctx: ModelCtx = ModelCtx(),
           hiddens: Optional[List[torch.Tensor]] = None):
    """The prefix layers, the repeated blocks, the final norm.  Every
    cache leaf updates in place.  ``hiddens``, when given, receives every
    layer's post-residual state (B, T, d), before the final norm: the
    prefix layers, then the repeats — the reference's ``collect_layers``
    list."""
    if cfg.prefix:
        pc = caches.get("prefix") if caches else None
        for i, spec in enumerate(cfg.prefix):
            c = pc[i] if pc is not None else None
            x, new_mc = _apply_layer(params["prefix"][i], x, cfg=cfg,
                                     spec=spec, positions=positions,
                                     cache=c, enc_out=enc_out, ctx=ctx)
            if c is not None:
                _store(c, new_mc)
            if hiddens is not None:
                hiddens.append(x)
    x = _run_blocks(params["blocks"], x, cfg=cfg, specs=cfg.block,
                    n_repeats=cfg.n_repeats, positions=positions,
                    caches=caches.get("blocks") if caches else None,
                    enc_out=enc_out, ctx=ctx, hiddens=hiddens)
    return ly.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(params, x, cfg: ArchConfig, ctx: ModelCtx = ModelCtx()):
    embed = params["embed"]
    if ctx.mesh is not None:
        embed = pops.gather_on_use(embed, ctx.model_axis)
        x = pops.settle(x, ctx.model_axis)
    return ly.logits(embed, x,
                     dataclasses.replace(cfg, vocab=padded_vocab(cfg)))


def _embed(params, tokens, ctx: ModelCtx):
    """The token embedding: vocab-sharded under a mesh
    (:func:`repro_torch.parallel.ops.sharded_embed`)."""
    return pops.sharded_embed(params["embed"]["tok"], tokens, ctx.mesh,
                              ctx.model_axis)


def _proj(params, name: str, ctx: ModelCtx):
    """A frontend or MTP projection, its FSDP shards gathered on use."""
    p = params[name]
    return pops.gather_on_use(p, ctx.model_axis) if ctx.mesh is not None \
        else p


def _on_mesh(tokens, ctx: ModelCtx):
    """(tokens, the context the forward runs in).  Under a mesh: the
    tokens as a DTensor sharded on the batch over the data dims when it
    divides (:func:`~repro_torch.parallel.sharding.batch_sharding`), and
    ``parallel.ops.replicating`` so plain tensors built inside the forward
    (positions, masks) join DTensor ops as replicated."""
    if ctx.mesh is None:
        return tokens, contextlib.nullcontext()
    from torch.distributed.tensor import distribute_tensor
    from ..parallel import sharding as sh
    if not pops.is_dtensor(tokens):
        spec = sh.batch_sharding(ctx.mesh, tuple(tokens.shape))
        tokens = distribute_tensor(tokens, ctx.mesh,
                                   sh.placements(spec, ctx.mesh),
                                   src_data_rank=None)
    return tokens, pops.replicating()


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _encoder(params, feats, *, cfg: ArchConfig,
             ctx: ModelCtx = ModelCtx()):
    x = ly.einsum("btf,fd->btd", feats,
                  _proj(params, "frontend", ctx)["proj"])
    x = _run_blocks(params["enc_blocks"], x, cfg=cfg, specs=cfg.enc_block,
                    n_repeats=cfg.n_enc_repeats, ctx=ctx)
    return ly.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device).expand(B, T)


def model_fwd(params, batch: Dict[str, torch.Tensor], *,
              cfg: ArchConfig, ctx: ModelCtx = ModelCtx()
              ) -> Dict[str, torch.Tensor]:
    """Full-sequence forward.  Returns {"logits", optional "mtp_logits"}.

    batch: tokens (B, T); audio/enc feats (B, Ts, F) for enc-dec; patch
    feats (B, P, F) for VLM prefix conditioning."""
    tokens, scope = _on_mesh(batch["tokens"], ctx)
    with scope:
        return _model_fwd(params, batch, tokens, cfg=cfg, ctx=ctx)


def _model_fwd(params, batch, tokens, *, cfg: ArchConfig, ctx: ModelCtx):
    B, T = tokens.shape
    x = _embed(params, tokens, ctx)
    enc_out = None
    n_prefix_tokens = 0
    if cfg.enc_dec:
        enc_out = _encoder(params, batch["enc_feats"], cfg=cfg, ctx=ctx)
    elif cfg.frontend == "vision":
        pre = ly.einsum("bpf,fd->bpd", batch["patch_feats"],
                        _proj(params, "frontend", ctx)["proj"])
        n_prefix_tokens = pre.shape[1]
        x = torch.cat(ly.promote(pre, x), dim=1)
    x = _trunk(params, x, cfg=cfg,
               positions=_positions(B, x.shape[1], tokens.device),
               enc_out=enc_out, ctx=ctx)
    if n_prefix_tokens:
        x = x[:, n_prefix_tokens:]
    out = {"logits": _head(params, x, cfg, ctx)}
    if cfg.mtp:
        mtp = _proj(params, "mtp", ctx)
        nxt = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
        h = torch.cat([ly.rms_norm(x, mtp["norm"], cfg.norm_eps),
                       nxt], dim=-1)
        h = ly.einsum("bte,ed->btd", h, mtp["proj"])
        out["mtp_logits"] = _head(params, h, cfg, ctx)
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
            ctx: ModelCtx = ModelCtx(), return_hidden: bool = False,
            collect_layers: bool = False):
    """Process the prompt, fill the cache, return last-position logits.

    batch: tokens (B, T), and enc feats (B, Ts, F) for enc-dec (the
    encoder output is not returned, as in the reference).
    ``return_hidden`` additionally returns the final-norm hidden state of
    the last position (B, 1, d_model) — the input of the output-head
    matmul, which coded serving executes as a distributed MDS-coded
    product instead of the local head contraction.

    ``collect_layers`` appends one more output: the list of per-layer
    post-residual hidden states (B, T, d_model), prefix layers first, then
    the repeats, before the final norm — the activations feeding each
    layer's matmuls, which trunk-scope coded serving distributes (and
    which its tests compare layer by layer)."""
    tokens, scope = _on_mesh(batch["tokens"], ctx)
    with scope:
        B, T = tokens.shape
        x = _embed(params, tokens, ctx)
        enc_out = _encoder(params, batch["enc_feats"], cfg=cfg, ctx=ctx) \
            if cfg.enc_dec else None
        hiddens = [] if collect_layers else None
        x = _trunk(params, x, cfg=cfg,
                   positions=_positions(B, T, tokens.device), caches=caches,
                   enc_out=enc_out, ctx=ctx, hiddens=hiddens)
        hidden = x[:, -1:]
        result = (_head(params, hidden, cfg, ctx), caches)
    if return_hidden:
        result += (hidden,)
    if collect_layers:
        result += (hiddens,)
    return result


def decode_step(params, tokens, pos, caches, *, cfg: ArchConfig,
                ctx: ModelCtx = ModelCtx(), enc_out=None,
                return_hidden: bool = False, collect_layers: bool = False):
    """One decode step.  tokens (B, 1), pos (B,) absolute positions;
    ``enc_out`` (B, Ts, d) feeds an encoder-decoder's cross-attention
    (without it the step skips cross-attention, as the reference's serving
    loop does).

    ``return_hidden`` additionally returns the final-norm hidden state
    (B, 1, d_model) feeding the output head; ``collect_layers`` the
    per-layer hidden states (see :func:`prefill`)."""
    tokens, scope = _on_mesh(tokens, ctx)
    with scope:
        x = _embed(params, tokens, ctx)
        hiddens = [] if collect_layers else None
        x = _trunk(params, x, cfg=cfg, positions=pos[:, None],
                   caches=caches, enc_out=enc_out, ctx=ctx, hiddens=hiddens)
        result = (_head(params, x, cfg, ctx), caches)
    if return_hidden:
        result += (x,)
    if collect_layers:
        result += (hiddens,)
    return result
