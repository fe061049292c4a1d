"""Hand-written Hopper kernels of the port, one package per kernel.

Each holds ``csrc/`` (the CUDA source), ``ops.py`` (the wrapper that
launches it, or its plain version for a CPU tensor) and ``ref.py`` (the
plain-torch version).  :mod:`.build` compiles the sources at first use.
"""
