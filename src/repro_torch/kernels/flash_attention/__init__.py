"""Flash attention: the CUDA counterpart of ``repro.kernels.flash_attention``."""
