"""InternVL2 26B [arXiv:2404.16821]: InternLM2-20B language backbone
(48L, d_model 6144, 48H GQA kv=8, d_ff 16384, vocab 92553) with an InternViT
vision frontend.  The frontend is a STUB per the brief: ``input_specs``
provides precomputed patch embeddings prepended to the token sequence."""
from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="swiglu")
    return ArchConfig(
        name="internvl2-26b", family="vlm",
        d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=16384, vocab=92553,
        block=(layer,), n_repeats=48,
        frontend="vision", frontend_dim=3200, frontend_len=1024,
        rope_base=1_000_000.0,
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="swiglu")
    return ArchConfig(
        name="internvl2-smoke", family="vlm",
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512,
        block=(layer,), n_repeats=2,
        frontend="vision", frontend_dim=48, frontend_len=16,
        dtype="float32",
    )
