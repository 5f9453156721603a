"""Jamba-1.5 Large 398B [arXiv:2403.19887]: 72L, d_model 8192, 64H GQA kv=8,
d_ff 24576, vocab 65536; attention:mamba 1:7 interleave, MoE 16e top-2 every
other layer.  Block of 8 layers = [attn, m, m, m, m, m, m, m] with MoE on the
even positions, repeated 9×.  Mamba state ⇒ long_500k runs."""
from repro_torch.models.config import ArchConfig, LayerSpec, MambaConfig, MoEConfig


def _block(window=None):
    layers = []
    for i in range(8):
        mixer = "attn" if i == 0 else "mamba"
        ffn = "moe" if i % 2 == 1 else "swiglu"
        layers.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(layers)


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=24576, vocab=65536,
        block=_block(), n_repeats=9,
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        subquadratic=True,
    )


def smoke_config() -> ArchConfig:
    layers = (LayerSpec(mixer="attn", ffn="swiglu"),
              LayerSpec(mixer="mamba", ffn="moe"),
              LayerSpec(mixer="mamba", ffn="swiglu"))
    return ArchConfig(
        name="jamba-smoke", family="hybrid",
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=512,
        block=layers, n_repeats=2,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        subquadratic=True,
        dtype="float32",
    )
