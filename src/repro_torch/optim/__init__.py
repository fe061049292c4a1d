"""Optimizer substrate: AdamW, schedules, clipping, compression
(``repro.optim`` counterpart)."""
from repro_torch.optim.adamw import (AdamWConfig, apply, clip_by_global_norm,
                                     global_norm, init, params_from_state)
from repro_torch.optim.compression import (compress, decompress,
                                           init_residuals)
from repro_torch.optim.schedule import (constant, inverse_sqrt,
                                        linear_warmup_cosine)

__all__ = ["AdamWConfig", "apply", "clip_by_global_norm", "global_norm",
           "init", "params_from_state", "compress", "decompress",
           "init_residuals", "constant", "inverse_sqrt",
           "linear_warmup_cosine"]
