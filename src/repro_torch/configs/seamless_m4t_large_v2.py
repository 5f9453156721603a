"""SeamlessM4T-large v2 [arXiv:2308.11596]: enc-dec transformer backbone,
24L encoder + 24L decoder, d_model 1024, 16H, d_ff 8192, vocab 256206.
The speech frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings (per the assignment brief)."""
from repro_torch.models.config import ArchConfig, LayerSpec


def config() -> ArchConfig:
    enc = LayerSpec(mixer="attn", ffn="gelu")
    dec = LayerSpec(mixer="attn", ffn="gelu")
    return ArchConfig(
        name="seamless-m4t-large-v2", family="audio",
        d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
        d_ff=8192, vocab=256206,
        block=(dec,), n_repeats=24,
        enc_dec=True, n_enc_repeats=24, enc_block=(enc,),
        frontend="audio", frontend_dim=256, frontend_len=1500,
        ffn_act="gelu",
        subquadratic=False,
    )


def smoke_config() -> ArchConfig:
    enc = LayerSpec(mixer="attn", ffn="gelu")
    dec = LayerSpec(mixer="attn", ffn="gelu")
    return ArchConfig(
        name="seamless-smoke", family="audio",
        d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=512,
        block=(dec,), n_repeats=2,
        enc_dec=True, n_enc_repeats=2, enc_block=(enc,),
        frontend="audio", frontend_dim=32, frontend_len=24,
        ffn_act="gelu",
        dtype="float32",
    )
