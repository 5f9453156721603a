"""DBRX 132B [hf:databricks/dbrx-base]: 40L, d_model 6144, 48H GQA kv=8,
MoE 16 experts top-4 (d_expert 10752), vocab 100352."""
from repro_torch.models.config import ArchConfig, LayerSpec, MoEConfig


def config() -> ArchConfig:
    moe = LayerSpec(mixer="attn", ffn="moe")
    return ArchConfig(
        name="dbrx-132b", family="moe",
        d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=10752, vocab=100352,
        block=(moe,), n_repeats=40,
        moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752),
        rope_base=500_000.0,
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    moe = LayerSpec(mixer="attn", ffn="moe")
    return ArchConfig(
        name="dbrx-smoke", family="moe",
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=96, vocab=512,
        block=(moe,), n_repeats=2,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=96),
        dtype="float32",
    )
