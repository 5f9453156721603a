"""Architecture configuration schema.

One ``ArchConfig`` describes any of the ten assigned architectures (plus the
paper's own workloads).  A model is a *prefix* of unrolled layers followed by
``n_repeats`` copies of a repeating ``block`` (a tuple of ``LayerSpec``s) —
the repeating unit is what ``jax.lax.scan`` runs over, which keeps the HLO
size independent of depth (61-layer DeepSeek compiles as fast as 16-layer
Llama).

Examples: gemma3's 5 local + 1 global pattern is a 6-layer block; jamba's
1:7 attention:mamba interleave with MoE every other layer is an 8-layer
block; DeepSeek-V3's first-3-dense is a 3-layer prefix + 58 MoE repeats.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence, Tuple

MixerKind = Literal["attn", "mamba", "rwkv"]
FFNKind = Literal["swiglu", "gelu", "relu2", "moe"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert hidden width
    n_shared: int = 0             # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""
    q_lora: int = 1536
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating block."""
    mixer: MixerKind = "attn"
    ffn: FFNKind = "swiglu"
    sliding_window: Optional[int] = None     # attention-only; None = global


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    prefix: Tuple[LayerSpec, ...] = ()
    block: Tuple[LayerSpec, ...] = (LayerSpec(),)
    n_repeats: int = 1

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None

    # RWKV-specific
    rwkv_head_size: int = 64

    ffn_act: str = "swiglu"          # activation used by dense FFN layers
    rope_base: float = 10_000.0
    rope_base_local: float = 10_000.0   # gemma3 uses a different local base
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mtp: bool = False                # DeepSeek multi-token-prediction head

    # encoder-decoder (seamless-m4t)
    enc_dec: bool = False
    n_enc_repeats: int = 0
    enc_block: Tuple[LayerSpec, ...] = ()

    # modality frontend stubs: precomputed embeddings arrive via input_specs
    frontend: Optional[Literal["audio", "vision"]] = None
    frontend_dim: int = 256          # feature dim of the precomputed stubs
    frontend_len: int = 1500         # frames/patches per example

    dtype: str = "bfloat16"

    # long-context capability flag (decides the long_500k dry-run cell)
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + len(self.block) * self.n_repeats

    @property
    def attn_type(self) -> str:
        return "mla" if self.mla is not None else "gqa"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for reporting
        and for the 6·N·D roofline term."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)

        def layer_params(spec: LayerSpec) -> int:
            p = 2 * d  # two RMSNorm gains
            if spec.mixer == "attn":
                if self.mla is not None:
                    m = self.mla
                    qk = m.nope_dim + m.rope_dim
                    p += d * m.q_lora + m.q_lora * self.n_heads * qk
                    p += d * (m.kv_lora + m.rope_dim)
                    p += m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim)
                    p += self.n_heads * m.v_dim * d
                else:
                    p += d * self.n_heads * self.d_head        # Q
                    p += 2 * d * self.n_kv_heads * self.d_head  # K, V
                    p += self.n_heads * self.d_head * d         # O
            elif spec.mixer == "mamba":
                mc = self.mamba or MambaConfig()
                di = mc.expand * d
                p += 2 * d * di + di * d                      # in/out proj
                p += di * (2 * mc.d_state + 2) + di * mc.d_conv
            elif spec.mixer == "rwkv":
                p += 5 * d * d + 2 * d * 64                   # r,k,v,g,o + decay lora
            if spec.ffn == "moe":
                m = self.moe
                p += d * m.num_experts * m.d_expert * 3
                p += d * m.n_shared * m.d_expert * 3
                p += d * m.num_experts                        # router
            elif spec.mixer == "rwkv":
                p += 2 * d * self.d_ff + d * d   # channel-mix (k, v, r)
            elif spec.ffn == "swiglu":
                p += 3 * d * self.d_ff
            else:
                p += 2 * d * self.d_ff
            return p

        for spec in self.prefix:
            total += layer_params(spec)
        for spec in self.block:
            total += layer_params(spec) * self.n_repeats
        for spec in self.enc_block:
            total += layer_params(spec) * self.n_enc_repeats
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        # subtract the inactive routed experts in every MoE layer
        n_moe_layers = sum(1 for s in self.prefix if s.ffn == "moe")
        n_moe_layers += sum(1 for s in self.block if s.ffn == "moe") * self.n_repeats
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return full - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)
