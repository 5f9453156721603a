"""Model zoo of the port: dense GQA decoders and RWKV-6 stacks."""
from .config import (ArchConfig, LayerSpec, MLAConfig, MambaConfig,  # noqa
                     MoEConfig)
from .lm import (decode_step, init_cache_shapes, init_model,  # noqa: F401
                 model_fwd, padded_vocab, prefill)
from .rwkv import (apply_rwkv_cmix, apply_rwkv_tmix,  # noqa: F401
                   init_rwkv_cmix, init_rwkv_tmix, rwkv_cache_spec)
