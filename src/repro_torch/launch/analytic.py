"""Analytic roofline estimator — the port of ``repro.launch.analytic``:
closed-form FLOPs / HBM bytes / collective bytes per rank for every (arch
× cell × mesh) combination, the reference's formulas unchanged.

The port's dry-run (:mod:`repro_torch.launch.dryrun`) counts one rank's
FLOPs itself (:class:`repro_torch.launch.roofline.StepTrace`), op by op on
the rank's local shards.  An eager step runs every loop trip (each repeat
of the block, each microbatch, each chunk), so that count holds the
estimator to the traced truth at full depth too — which the reference's
comparison with XLA's ``cost_analysis()`` (one count per ``while`` body)
could not.  ``tests/test_torch_analysis.py`` holds the two within
tolerance on small configs and on llama3.2-1b at its published widths and
depth.

Conventions: everything is *per rank*; the model dim (TP) and the data
dims (DP) divide work evenly (KV-head replication under-division is
ignored — <2% on these configs).  bf16 activations/weights, fp32
accumulators.  :meth:`AnalyticCosts.terms` defaults to one H100's peaks
(:data:`repro_torch.launch.roofline.HW`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..models import ArchConfig, ShapeCell
from ..models.config import LayerSpec, MambaConfig
from ..models.moe import moe_capacity  # noqa: F401
from .roofline import HW

__all__ = ["AnalyticCosts", "estimate", "MeshDesc", "expert_param_count"]

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    dp: int                     # product of data axes (pod × data)
    tp: int                     # model axis

    @property
    def chips(self) -> int:
        return self.dp * self.tp


@dataclasses.dataclass
class AnalyticCosts:
    flops: float                # per device
    hbm_bytes: float            # per device
    ici_bytes: float            # per device
    breakdown: Dict[str, float]

    def terms(self, peak=HW["peak_flops"], hbm=HW["hbm_bw"],
              ici=HW["ici_bw"]) -> Dict[str, float]:
        return {"compute": self.flops / peak,
                "memory": self.hbm_bytes / hbm,
                "collective": self.ici_bytes / ici}


def _layer_list(cfg: ArchConfig):
    layers = list(cfg.prefix)
    layers += list(cfg.block) * cfg.n_repeats
    return layers


def _attn_matmul_flops(cfg: ArchConfig, D: float, T_ctx: float,
                       spec: LayerSpec, decode: bool) -> Tuple[float, float]:
    """(projection flops, score/value flops) for D query tokens with average
    context T_ctx."""
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        H = cfg.n_heads
        qk = m.nope_dim + m.rope_dim
        proj = 2 * D * (d * m.q_lora + m.q_lora * H * qk
                        + d * (m.kv_lora + m.rope_dim))
        if decode:
            # absorbed: q→latent per head, scores/values over latent cache
            proj += 2 * D * H * (m.nope_dim * m.kv_lora + m.kv_lora * m.v_dim)
            sv = 2 * D * H * T_ctx * (m.kv_lora + m.rope_dim + m.kv_lora)
        else:
            proj += 2 * D * m.kv_lora * H * (m.nope_dim + m.v_dim)
            sv = 2 * D * H * T_ctx * (qk + m.v_dim)
        proj += 2 * D * H * m.v_dim * d
        return proj, sv
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    proj = 2 * D * (d * Hq * Dh + 2 * d * Hkv * Dh + Hq * Dh * d)
    sv = 2 * D * Hq * T_ctx * 2 * Dh
    return proj, sv


def _ctx_len(cell: ShapeCell, spec: LayerSpec) -> float:
    """Average context length per query token."""
    if cell.kind == "decode":
        S = cell.seq_len
        return min(S, spec.sliding_window) if spec.sliding_window else S
    T = cell.seq_len
    if spec.sliding_window:
        return min(spec.sliding_window, T)
    return (T + 1) / 2.0                      # causal average


def _layer_fwd_flops(cfg: ArchConfig, spec: LayerSpec, D: float,
                     cell: ShapeCell) -> float:
    d = cfg.d_model
    decode = cell.kind == "decode"
    f = 0.0
    if spec.mixer == "attn":
        proj, sv = _attn_matmul_flops(cfg, D, _ctx_len(cell, spec), spec,
                                      decode)
        f += proj + sv
    elif spec.mixer == "mamba":
        mc = cfg.mamba or MambaConfig()
        di = mc.expand * d
        f += 2 * D * (2 * d * di + di * d)                  # in/out proj
        f += 2 * D * di * mc.d_conv                         # conv
        f += 2 * D * di * (2 * mc.d_state + 1)              # B,C,dt proj
        f += 6 * D * di * mc.d_state                        # scan update+mix
    elif spec.mixer == "rwkv":
        hs = cfg.rwkv_head_size
        C = 64.0 if not decode else 1.0                      # chunk length
        f += 2 * D * 5 * d * d                               # r,k,v,g,o
        f += 2 * D * (d * 64 + 64 * d)                       # decay lora
        if decode:
            f += 4 * D * d * hs                              # state update
        else:
            f += 2 * D * C * d * 2                           # intra-chunk P,PV
            f += 6 * D * d * hs                              # carry + state
    if spec.ffn == "moe":
        m = cfg.moe
        routed_tokens = D * m.top_k * m.capacity_factor
        f += 2 * D * d * m.num_experts                       # router
        f += 2 * routed_tokens * 3 * d * m.d_expert          # experts (SwiGLU)
        f += 2 * D * 3 * d * (m.n_shared * m.d_expert)       # shared experts
    elif spec.mixer == "rwkv":
        f += 2 * D * (d * cfg.d_ff + cfg.d_ff * d + d * d)   # cmix (k,v,r)
    elif spec.ffn == "swiglu":
        f += 2 * D * 3 * d * cfg.d_ff
    else:
        f += 2 * D * 2 * d * cfg.d_ff
    return f


def _cross_attn_flops(cfg: ArchConfig, D: float, T_enc: float) -> float:
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.d_head
    proj = 2 * D * (d * H * Dh + H * Dh * d) + 2 * (T_enc) * 2 * d * H * Dh
    sv = 2 * D * H * T_enc * 2 * Dh
    return proj + sv


def expert_param_count(cfg: ArchConfig) -> int:
    """Parameters held in routed-expert weights (the full-mesh-EP target)."""
    if cfg.moe is None:
        return 0
    m = cfg.moe
    n_moe = sum(1 for s in _layer_list(cfg) if s.ffn == "moe")
    return n_moe * 3 * cfg.d_model * m.d_expert * m.num_experts


def estimate(cfg: ArchConfig, cell: ShapeCell, mesh: MeshDesc, *,
             n_micro: int = 1, fsdp: bool = True,
             remat: bool = True, ep_full: bool = False,
             acc_dtype: str = "float32",
             remat_policy: str = "full",
             a2a_fp8: bool = False) -> AnalyticCosts:
    # remat_policy "dots": matmul outputs saved — the bwd pass re-runs only
    # elementwise ops, so weight re-gathers and MoE dispatch drop from 3
    # events (fwd + bwd + remat-recompute) to 2, and the recompute FLOPs
    # shrink from ~1 extra fwd to ~0.3.
    B, T = cell.global_batch, cell.seq_len
    kind = cell.kind
    d, V = cfg.d_model, cfg.vocab
    P = cfg.param_count()
    chips = mesh.chips

    if kind == "train":
        D = float(B) * T                    # query tokens per step
    elif kind == "prefill":
        D = float(B) * T
    else:
        D = float(B)                        # one token per sequence

    if cfg.frontend == "vision" and kind != "decode":
        D = float(B) * (T - cfg.frontend_len) + float(B) * cfg.frontend_len
        # (text + patch positions both flow through the trunk)

    # ---- forward FLOPs (whole system) -----------------------------------
    fwd = 0.0
    br: Dict[str, float] = {}
    for spec in _layer_list(cfg):
        fwd += _layer_fwd_flops(cfg, spec, D, cell)
    if cfg.enc_dec:
        D_enc = float(B) * cfg.frontend_len
        enc_cell = dataclasses.replace(cell, kind="prefill",
                                       seq_len=cfg.frontend_len)
        for spec in list(cfg.enc_block) * cfg.n_enc_repeats:
            fwd += _layer_fwd_flops(cfg, spec, D_enc, enc_cell)
        fwd += len(_layer_list(cfg)) * _cross_attn_flops(cfg, D, cfg.frontend_len)
    # logits (+MTP)
    fwd += 2 * D * d * V * (2 if cfg.mtp and kind == "train" else 1)
    if cfg.mtp and kind == "train":
        fwd += 2 * D * (2 * d) * d

    n_events = 2 if remat_policy == "dots" else (3 if remat else 2)
    if kind == "train":
        remat_extra = 0.3 if remat_policy == "dots" else (1.0 if remat else 0.0)
        total_flops = fwd * (3.0 + remat_extra)
    else:
        total_flops = fwd
    flops_dev = total_flops / chips
    br["flops_fwd_global"] = fwd

    # ---- HBM bytes per device -------------------------------------------
    # with full-mesh EP the expert weights never leave their home shard
    P_ep = expert_param_count(cfg) if ep_full else 0
    P_gath = P - P_ep                     # weights that FSDP gathers
    acc_bytes = F32 if acc_dtype == "float32" else BF16
    P_dev = P * BF16 / chips if fsdp else P * BF16 / mesh.tp
    act_unit = (D / mesh.dp) * d * BF16          # one activation tensor/device
    n_layers = len(_layer_list(cfg)) + (cfg.n_enc_repeats
                                        * len(cfg.enc_block) if cfg.enc_dec else 0)
    hbm = 0.0
    if kind == "train":
        # weights: gather-write + read, fwd + bwd (+ remat re-run), per micro
        w_events = n_events
        hbm += (n_micro * w_events * 2 * (P_gath * BF16 / mesh.tp)
                + n_micro * w_events * 2 * P_ep * BF16 / chips) \
            if fsdp else n_micro * w_events * P_dev
        # optimizer: read p,m,v + write p,m,v (bf16 states) + grad acc rw
        hbm += 6 * P * BF16 / chips + 2 * P * acc_bytes / chips
        # activations: ~18 tensor read/writes per layer fwd, ×3 with bwd+remat
        hbm += n_layers * 18 * 3 * act_unit
        # logits fp32 softmax (+bwd)
        hbm += 3 * (D / mesh.dp) * (V / mesh.tp) * F32
        br["hbm_weights"] = n_micro * 3 * 2 * P_gath * BF16 / mesh.tp
        br["hbm_opt"] = 6 * P * BF16 / chips + 2 * P * acc_bytes / chips
        br["hbm_acts"] = n_layers * 18 * 3 * act_unit
    else:
        hbm += 2 * P_dev if fsdp else P_dev     # stream weights once
        hbm += n_layers * 12 * act_unit
        hbm += (D / mesh.dp) * (V / mesh.tp) * BF16
        if kind == "decode":
            hbm += _kv_cache_bytes(cfg, cell) / chips   # read the cache
            br["hbm_kv_cache"] = _kv_cache_bytes(cfg, cell) / chips

    # ---- collective bytes per rank (the reference's ici_* names) -------
    ici = 0.0
    if kind == "train":
        if fsdp:
            gather_events = n_events * n_micro
            ici += gather_events * (P_gath * BF16 / mesh.tp) \
                * (mesh.dp - 1) / mesh.dp
            br["ici_fsdp_gather"] = gather_events * (P_gath * BF16 / mesh.tp)
        # grad reduce-scatter once per micro (the accumulator is sharded);
        # full-EP expert grads are already fully sharded — no DP reduction
        ici += n_micro * (P_gath * BF16 / mesh.tp) * (mesh.dp - 1) / mesh.dp
        # TP all-reduces: 2 per layer, fwd+bwd(+remat) (ring ⇒ 2× payload);
        # act_unit already covers the *whole* step's tokens, so the microbatch
        # factor cancels (n_micro × tokens/n_micro).
        tp_events = 2 * n_layers * n_events
        ici += tp_events * 2 * act_unit * (mesh.tp - 1) / mesh.tp
        br["ici_tp_allreduce"] = tp_events * 2 * act_unit
    else:
        tp_events = 2 * n_layers
        ici += tp_events * 2 * act_unit * (mesh.tp - 1) / mesh.tp
    # MoE all-to-alls
    if cfg.moe is not None:
        n_moe = sum(1 for s in _layer_list(cfg) if s.ffn == "moe")
        tok_dev = D / mesh.dp
        dir_bytes = (0.5 + 1.0) if a2a_fp8 else 2.0   # dispatch + return
        a2a = dir_bytes * min(cfg.moe.top_k * cfg.moe.capacity_factor,
                              mesh.tp) * tok_dev * d * BF16
        events = n_events if kind == "train" else 1
        ici += n_moe * events * a2a
        br["ici_moe_a2a"] = n_moe * events * a2a
    # vocab-psum for the sharded embed (psum of (D/dp, d) per micro)
    ici += (3 if kind == "train" else 1) * 2 * act_unit

    return AnalyticCosts(flops=flops_dev, hbm_bytes=hbm, ici_bytes=ici,
                         breakdown=br)


def _kv_cache_bytes(cfg: ArchConfig, cell: ShapeCell) -> float:
    B, S = cell.global_batch, cell.seq_len
    total = 0.0
    for spec in _layer_list(cfg):
        if spec.mixer == "attn":
            if cfg.mla is not None:
                total += B * S * (cfg.mla.kv_lora + cfg.mla.rope_dim) * BF16
            else:
                w = min(S, spec.sliding_window) if spec.sliding_window else S
                total += B * w * 2 * cfg.n_kv_heads * cfg.d_head * BF16
        elif spec.mixer == "mamba":
            mc = cfg.mamba or MambaConfig()
            total += B * mc.expand * cfg.d_model * mc.d_state * F32
        elif spec.mixer == "rwkv":
            total += B * cfg.d_model * cfg.rwkv_head_size * F32
    return total
