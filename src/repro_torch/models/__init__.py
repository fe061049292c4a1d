"""Model zoo of the port: the dense, ssm and hybrid families
(``repro.models`` counterpart)."""
from repro_torch.models.model import (DenseLM, count_params, decode_step,
                                      forward, init_cache, init_params,
                                      loss_fn, param_shapes, prefill)

__all__ = ["DenseLM", "count_params", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "param_shapes", "prefill"]
