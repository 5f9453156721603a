"""Gemma-3 12B [hf:google/gemma-3-12b-pt]: 48L, d_model 3840, 16H GQA kv=8
(d_head 256), d_ff 15360, vocab 262144, 5:1 local(window 1024):global
attention, dual RoPE bases (10k local / 1M global), 128k context.

The 5:1 sliding:global pattern keeps the effective KV state sub-quadratic
in practice, so this arch runs the long_500k cell (DESIGN.md §4)."""
from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    local = LayerSpec(mixer="attn", ffn="swiglu", sliding_window=1024)
    glob = LayerSpec(mixer="attn", ffn="swiglu", sliding_window=None)
    return ArchConfig(
        name="gemma3-12b", family="dense",
        d_model=3840, n_heads=16, n_kv_heads=8, d_head=256,
        d_ff=15360, vocab=262144,
        block=(local, local, local, local, local, glob), n_repeats=8,
        rope_base=1_000_000.0, rope_base_local=10_000.0,
        tie_embeddings=True,
        subquadratic=True,
    )


def smoke_config() -> ArchConfig:
    local = LayerSpec(mixer="attn", ffn="swiglu", sliding_window=8)
    glob = LayerSpec(mixer="attn", ffn="swiglu", sliding_window=None)
    return ArchConfig(
        name="gemma3-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512,
        block=(local, local, glob), n_repeats=2,
        rope_base=1_000_000.0, rope_base_local=10_000.0,
        tie_embeddings=True,
        subquadratic=True,
        dtype="float32",
    )
