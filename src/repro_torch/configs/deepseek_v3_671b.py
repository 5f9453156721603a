"""DeepSeek-V3 671B [arXiv:2412.19437]: 61L, d_model 7168, 128 MLA heads,
MoE 1 shared + 256 routed top-8 (d_expert 2048), first 3 layers dense
(d_ff 18432), MTP head, vocab 129280."""
from repro_torch.models.config import ArchConfig, LayerSpec, MLAConfig, MoEConfig


def config() -> ArchConfig:
    dense = LayerSpec(mixer="attn", ffn="swiglu")
    moe = LayerSpec(mixer="attn", ffn="moe")
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        d_model=7168, n_heads=128, n_kv_heads=128, d_head=128,
        d_ff=18432, vocab=129280,
        prefix=(dense, dense, dense),
        block=(moe,), n_repeats=58,
        mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                      v_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, n_shared=1),
        mtp=True,
        rope_base=10_000.0,
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    dense = LayerSpec(mixer="attn", ffn="swiglu")
    moe = LayerSpec(mixer="attn", ffn="moe")
    return ArchConfig(
        name="deepseek-v3-smoke", family="moe",
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=512,
        prefix=(dense,),
        block=(moe,), n_repeats=2,
        mla=MLAConfig(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16,
                      v_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, n_shared=1),
        mtp=True,
        dtype="float32",
    )
