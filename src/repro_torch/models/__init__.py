"""Model zoo of the port: composable torch LM stacks covering the ten
assigned archs (the reference's ``ModelCtx``, a mesh context, waits for
the port's parallelism)."""
from .config import (ArchConfig, LayerSpec, MLAConfig, MambaConfig,  # noqa
                     MoEConfig, SHAPE_CELLS, ShapeCell, shape_cell)
from .lm import (decode_step, init_cache_shapes, init_model,  # noqa: F401
                 model_fwd, padded_vocab, prefill)
from .rwkv import (apply_rwkv_cmix, apply_rwkv_tmix,  # noqa: F401
                   init_rwkv_cmix, init_rwkv_tmix, rwkv_cache_spec)
