"""Nemotron-4 15B [arXiv:2402.16819]: 32L, d_model 6144, 48H GQA kv=8,
d_ff 24576, squared-ReLU FFN, vocab 256000."""
from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="relu2")
    return ArchConfig(
        name="nemotron-4-15b", family="dense",
        d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=24576, vocab=256000,
        block=(layer,), n_repeats=32,
        ffn_act="relu2",
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    layer = LayerSpec(mixer="attn", ffn="relu2")
    return ArchConfig(
        name="nemotron-smoke", family="dense",
        d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=256, vocab=512,
        block=(layer,), n_repeats=2,
        ffn_act="relu2",
        dtype="float32",
    )
