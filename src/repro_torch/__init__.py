"""PyTorch/CUDA port of the TRA system (``repro``), for one NVIDIA H100.

Mirrors ``repro``'s layout and public names (``repro/X/y.py`` ↔
``repro_torch/X/y.py``) with torch tensors, explicit devices and
``torch.Generator``\\ s inside.  It imports neither ``jax`` nor ``repro``.
Entry points default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.

This slice ports the serving path of the §5.3 FFNN scorer: the kernel
registry, tensor relations, plan IR, cost model, optimizer, ``Expr``
frontend, ``Engine`` (``reference``/``jit``), ``TraServer`` with its load
generator, and the blocked matmul as a hand-written CUDA kernel
(:mod:`repro_torch.kernels.matmul`).  ``ROADMAP.md`` lists the slices
still to come.
"""
