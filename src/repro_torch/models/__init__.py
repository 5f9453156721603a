"""Model zoo of the port: composable torch LM stacks covering the ten
assigned archs.  ``ModelCtx`` carries the remat policy and the mesh
fields (``mesh``, ``model_axis``, ``ep_full``, ``a2a_fp8``)."""
from .config import (ArchConfig, LayerSpec, MLAConfig, MambaConfig,  # noqa
                     MoEConfig, SHAPE_CELLS, ShapeCell, shape_cell)
from .lm import (ModelCtx, decode_step, init_cache_shapes,  # noqa: F401
                 init_model, model_fwd, padded_vocab, prefill)
from .rwkv import (apply_rwkv_cmix, apply_rwkv_tmix,  # noqa: F401
                   init_rwkv_cmix, init_rwkv_tmix, rwkv_cache_spec)
