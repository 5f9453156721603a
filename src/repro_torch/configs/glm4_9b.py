"""GLM-4 9B [hf:THUDM/glm-4-9b]: 40L, d_model 4096, 32H GQA kv=2,
d_ff 13696, RoPE, vocab 151552."""
from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="swiglu")
    return ArchConfig(
        name="glm4-9b", family="dense",
        d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
        d_ff=13696, vocab=151552,
        block=(layer,), n_repeats=40,
        rope_base=10_000.0,
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="swiglu")
    return ArchConfig(
        name="glm4-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab=512,
        block=(layer,), n_repeats=2,
        dtype="float32",
    )
