"""SSD scan: the CUDA counterpart of ``repro.kernels.ssd_scan``."""
