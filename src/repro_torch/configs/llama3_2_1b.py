"""Llama-3.2 1B [hf:meta-llama/Llama-3.2-1B]: 16L, d_model 2048, 32H GQA
kv=8 (d_head 64), d_ff 8192, vocab 128256, tied embeddings."""
from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="swiglu")
    return ArchConfig(
        name="llama3.2-1b", family="dense",
        d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
        d_ff=8192, vocab=128256,
        block=(layer,), n_repeats=16,
        rope_base=500_000.0,
        tie_embeddings=True,
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="swiglu")
    return ArchConfig(
        name="llama3.2-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512,
        block=(layer,), n_repeats=2,
        tie_embeddings=True,
        dtype="float32",
    )
