"""RWKV-6 "Finch" 7B [arXiv:2404.05892]: 32L, d_model 4096, attention-free
(64 heads × head_size 64 WKV), channel-mix d_ff 14336, vocab 65536.
Constant-size recurrent state ⇒ long_500k runs."""
from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    layer = LayerSpec(mixer="rwkv", ffn="swiglu")  # ffn field unused: cmix
    return ArchConfig(
        name="rwkv6-7b", family="ssm",
        d_model=4096, n_heads=64, n_kv_heads=64, d_head=64,
        d_ff=14336, vocab=65536,
        block=(layer,), n_repeats=32,
        rwkv_head_size=64,
        subquadratic=True,
    )


def smoke_config() -> ArchConfig:
    layer = LayerSpec(mixer="rwkv", ffn="swiglu")
    return ArchConfig(
        name="rwkv6-smoke", family="ssm",
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=512,
        block=(layer,), n_repeats=2,
        rwkv_head_size=16,
        subquadratic=True,
        dtype="float32",
    )
