"""PyTorch/CUDA port of the TRA system (``repro``), for one NVIDIA H100.

Mirrors ``repro``'s layout and public names (``repro/X/y.py`` ↔
``repro_torch/X/y.py``) with torch tensors, explicit devices and
``torch.Generator``\\ s inside.  It imports neither ``jax`` nor ``repro``.
Entry points default to ``device="cuda"`` and raise without a card unless
the caller passes ``device="cpu"``.

Slice 1 ports the serving path of the §5.3 FFNN scorer: the kernel
registry, tensor relations, plan IR, cost model, optimizer, ``Expr``
frontend, ``Engine`` (``reference``/``jit``), ``TraServer`` with its load
generator, and the blocked matmul as a hand-written CUDA kernel
(:mod:`repro_torch.kernels.matmul`).  Slice 2 ports the dense family of
the model zoo (:mod:`repro_torch.models`, gemma2/qwen2/qwen2.5/minitron)
served by ``launch.serve --dense-oracle``, with flash attention as a
hand-written CUDA kernel (:mod:`repro_torch.kernels.flash_attention`).
Slice 3 ports the ssm family (mamba2-130m, Mamba2 blocks) through the same
loop, with the chunked SSD scan as a hand-written CUDA kernel
(:mod:`repro_torch.kernels.ssd_scan`).  Slice 4 rebuilds the bf16 flash
attention on Hopper's tensor cores (``wgmma`` and a TMA ring); f32
attention stays on the FFMA kernel.  ``ROADMAP.md`` lists the slices
still to come.
"""
