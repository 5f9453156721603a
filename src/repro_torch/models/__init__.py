"""Model zoo of the port (dense GQA decoders in this slice)."""
from .config import (ArchConfig, LayerSpec, MLAConfig, MambaConfig,  # noqa
                     MoEConfig)
from .lm import (decode_step, init_cache_shapes, init_model,  # noqa: F401
                 model_fwd, padded_vocab, prefill)
