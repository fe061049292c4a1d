"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # on a machine with one H100

Drives the port's twelve main paths — the §5.3 FFNN scorer at the paper's
speech-100k width (1600 features, 100000 hidden units, 10 labels) served
through ``TraServer`` on the ``jit`` executor; ``RecurrentLM``'s
continuous-batching decode at gemma2-2b's width (d_model 2304, vocab
256000) served through ``TraServer`` as well; the same FFNN trained at
that width on a minibatch of 10000 through ``TraTrainer``, plan-level
autodiff and AdamW, and again with a ``CheckpointStore``, killed,
recovered and resumed, and again through ``Engine(mesh,
executor="shard_map" | "gspmd")`` on ``torch.distributed`` (one rank over
NCCL, two ranks sharing the card over gloo); its forward at that width
streamed from a host
``RelationStore`` under a 1 GiB and a 4 GiB device budget, with the
``degrade`` ladder recovering a real out-of-memory error; gemma2-2b at full width
(26 layers, d_model 2304, vocab 256000), mamba2-130m at full width (24
Mamba2 layers, d_model 768, 24 SSD heads of dim 64, state 128, chunk 128,
vocab 50280) and zamba2-7b at full width (78 Mamba2 layers in 13 groups of
6, each followed by one of 2 shared attention + MLP blocks; d_model 3584,
112 SSD heads of dim 64, state 64, chunk 128, 32/32 attention heads of dim
112, d_ff 14336, vocab 32000; 6.72 B parameters), each model through the
``--dense-oracle`` prefill + greedy decode loop with random bf16 weights
from seed 0; gemma2-2b, mamba2-130m and zamba2-7b (cut to 12 Mamba2
layers) trained for 6 AdamW steps — and holds every hand-written kernel
of those paths against its plain PyTorch version on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles the CUDA sources of ``src/repro_torch/kernels/`` (one
   ``nvcc`` per source, all started together), and counts the ``HGMMA``
   instructions (``wgmma``) in the flash, SSD and matmul libraries' SASS
   and the ``UTMALDG`` (TMA loads) in the matmul library's: none fails;
3. lint: ``python -m repro_torch.analysis.lint`` on the card — every
   verifier pass over the program corpus and the strict engine compile of
   the §5.3 train step — exits 0;
4. kernels: ``matmul`` against ``matmul_ref`` at the shapes of the JAX
   package's kernel tests, a ragged shape (M, N and K off the tiles) and
   the scorer's two products (f32 with at most 16 rows through the skinny
   kernel, f32 with more rows and more than 32 columns through the
   tensor-core route, f32 with more rows and at most 32 columns through
   the narrow kernel, bf16 through the tile kernel; the skinny and
   tensor-core products also through the tile kernel, the route they took
   over), and the tile kernel's split-K reduction pass
   (``splitk_reduce``, off every main path) against ``splitk_reduce_ref``
   at the partial sums of the scorer's second product, each with kernel /
   plain / library times and the bound; then the skinny kernel on blocked views read in place
   (a scorer-shaped W1, blocks with ragged edges, W2's 40-byte rows: no
   copy) and on an operand off 16 bytes (one copy), and its split-K fold
   bit-equal to ``splitk_reduce_ref`` on its own partial tiles (drawn from
   a generator of their own, so the flash phase draws what it drew);
5. flash: ``attention`` against ``attention_ref`` at the JAX kernel
   tests' cases (f32 at 2e-4, bf16 at 3e-2), ragged lengths, ``sq <
   skv``, ``dv != d`` and gemma2-2b's two layer shapes (B=2, S=8192,
   D=256, soft-cap 50: window 4096 and global; bf16 within half a bf16
   step plus ``GEMMA2_BF16_DELTA`` of the exact f64 attention, f32 at
   2e-4), every case also within a limit on each output row's error over
   that row's norm (bf16 1e-2, f32 1e-4); every bf16 case through the
   tensor-core kernel (``TC_LAUNCHES``), every f32 case through the FFMA
   kernel (``FFMA_LAUNCHES``); zamba2-7b's shared attention (B=2, S=8192,
   32/32 heads, D=112, causal, no soft-cap) gated as gemma2's shapes are,
   timed in both types with the bound and ``scaled_dot_product_attention``
   beside the bf16 kernel; at gemma2's head shape (8 seeds, S=256)
   the bf16 kernel's outputs that differ from the correctly rounded f64
   attention within ``FLASH_ROUNDING_FACTOR`` times the plain f32
   version's count; timed at the gemma2 shapes in bf16 and at the global
   shape in f32, with the bound, and ``scaled_dot_product_attention``
   beside each kernel at the global shape without soft-cap;
6. serve: 64 Poisson-arriving requests through ``TraServer`` with every
   kernel launch count set to 0 just before and read just after (per
   dispatch 2 launches of the skinny kernel, 1 of them folding, and no
   tile kernel, reduction or copy); each response is checked against the
   scorer's per-request oracle; one bucket-8 dispatch timed whole, the W1
   copy the parent tree made, and each product at bucket 8 timed in place
   as the engine calls it, beside ``torch.matmul`` on the copied 2-D
   operands, the tile kernel there (the parent's path) and the bound;
7. train: ``ffnn_train_step_tra`` at speech-100k (N 10000, D 1600, H
   100000, L 10, f32, blocked nb 10, db 4, hb 10, lb 1) through
   ``TraTrainer(Engine(device="cuda", executor="jit",
   validate="strict"), ...)`` (every engine of the train, ckpt, serve and
   oocore phases compiles under ``"strict"``; the step plan's diagnostics
   by pass and severity, the verifier's host ms — the median of 5
   ``verify_plans`` calls on the compiled plans — and the memory pass's
   two peak models beside ``max_memory_allocated`` printed) with
   AdamW(``TRAIN_LR``, 1e-5), data and weights drawn on the card as
   ``benchmarks/train.py`` draws them, for 5 steps with every launch
   count set to 0 just before and read just after: 1 compile and 4 cached
   dispatches, the loss finite and lower at the last step than at the
   first, per step 1 launch of the tensor-core kernel and 2 of its split
   pass (X·W1), 1 of the narrow kernel (a1·W2, split in K and folding its
   sum in the same launch), none of the tile kernel, the split-K pass or
   the skinny kernel, and no operand copy; step 1's loss, AdamW moments and parameters, and
   one SGD(0.01) step's parameters, against the same step with the matmul
   op's plain version on the card and against a dense f64 step on the
   card, each within ``tolerance(k, f32)`` of the product computing it
   (AdamW's parameters where the reference |g| exceeds
   ``ADAM_GATE_ATOLS`` times the atol; W1's first moment against f64
   everywhere, the f64 step taking relu' from the kernel's z1, and
   against the plain run outside the columns where the kernel's and the
   plain run's z1 differ in sign, each such sign within the z1 limit of
   0); z1 itself within ``tolerance(1600, f32)`` of the f64 product; step
   ms (median of steps 2-5), peak memory, a profile of one step by
   kernel, and each forward product timed on its route beside the FFMA
   tile kernel (with its split-K pass: the route both took before), the
   plain version, ``torch.matmul`` and the bounds (X·W1: its split passes
   and the tensor-core kernel alone, too), with the split-K pass at
   a1·W2's partial sums (off the path) beside ``sum(0)``;
8. ckpt: the same training on a ``CheckpointStore`` (a temporary
   directory, ``keep=2``; removed at the end): 8 uninterrupted steps; a
   run checkpointed every 2 steps whose dispatch 5 (the 6th) raises an
   injected ``SimulatedFailure``, recovered from step 4 and ending at
   step 6; a fresh trainer on a fresh strict engine resuming to step 8 —
   the injector's log holds the one failure, the recovered and resumed
   losses, parameters and AdamW moments equal the uninterrupted run's
   bit for bit, and each run launches 1 tensor-core + 2 split + 1 narrow
   a dispatched step (the failed dispatch launches nothing); the
   snapshot's bytes and device-to-host ms, the writer's seconds a save,
   the stall in ``wait()`` at each save, each restore's ms from disk to
   the card, and the recovered run's wall time against 6 steps;
9. mesh: the same training through ``Engine(mesh, executor=...)`` on a
   ``("sites",)`` mesh, X and Y partitioned by rows and W1, W2 replicated
   (``tests/_distributed_checks.py:229``'s plan), on both executors:
   ``mesh1`` at world size 1 over NCCL in this process, ``mesh2`` at world
   size 2, two processes sharing the card over gloo (``run_sites``, a
   deadline; NCCL refuses two ranks on one card).  Each run: step 1 at
   AdamW(``CHECK_LR``) held by ``train_checks`` against the dense f64 step
   and the plain-matmul step (computed once for both sizes); then 3 steps
   at ``TRAIN_LR`` on a fresh strict engine with every launch count and
   ``shardmap_exec.COLLECTIVES`` 0 just before and read just after: 1
   compile and 2 cached dispatches, each rank's launches equal to the
   routes of its dispatch's products (``mesh_products``: at one rank the
   train path's 1 tensor-core + 2 split + 1 narrow, at two ranks the
   plan's 3 products a rank), on ``shard_map`` each step's executed
   collectives equal to ``expected_schedule`` (the static lowering), the
   ranks' step-1 losses alike; mesh1's losses, parameters and moments
   equal to the ``jit`` engine's same steps bit for bit, mesh2's
   losses within ``MESH_LOSS_RTOL`` of mesh1's.  Printed beside the card's
   name and power limit: ms a step (median of steps 2–3), each step's
   bytes by collective kind, the re-placed inputs' and the staged bytes,
   the exchange's ms, each rank's peak, ``compiled.cost``.  Not a scaling
   figure: two ranks share one card.  The phase frees every byte it
   allocated (``cublas_warm``, ``phase_allocated``: cuBLAS's workspace
   and the fold tickets are kept for the process);
10. oocore: the same network's forward z2 = relu(X·W1)·W2 at speech-100k
   (X, W1, W2 drawn as the train phase draws them) streamed from a host
   ``RelationStore`` (every block page-locked) through
   ``Engine(executor="jit", memory_budget=...)``: W1 (blocked along its
   hidden key dim) and W2 from the host under 1 GiB — stream-reduce, 10
   chunks a run, 644,000,000 bytes to the card a run, the model's peak
   within the budget, 1 tensor-core + 2 split + 1 narrow launch a chunk
   (by ``mm_ops.route`` of the chunk shapes), a second run a cache hit —
   and X from the host under 4 GiB — stream-out, 3 chunks of 4, 4 and 2
   keys, the output joined on the card; each within ``tolerance(100000,
   f32)`` of the f64 z2 computed on the card, as the resident run of the
   same engine kind is; the median of 5 synchronized runs beside the
   resident run's, the card's peak over a run beside the model's and the
   budget, the copy time and its hidden share from the copy stream's
   events, and the card's page-locked and pageable host→device rates on
   64 MB.  Then the ``degrade`` ladder: under a 4 GiB cap
   (``set_per_process_memory_fraction``, ``REPRO_DEVICE_MEMORY_BUDGET``
   the same) the resident z2 from numpy inputs raises
   ``torch.OutOfMemoryError`` and ``Engine(degrade=True)`` returns it on
   rung 1 (streamed at a quarter of the cap, one ``RuntimeWarning``), the
   cap and the environment restored in a ``finally``; a2 = σ(z2) under
   ``FaultInjector().inject_oom(ok_chunk=8)`` walks rung 2's chunks 64,
   32, 16 and completes at 8 on the chunked lowering, held against σ of
   the f64 z2; a ``TraReKey`` over z2 compiled streamed with ``force``
   under 1 GiB refuses with the streaming pass's ``[streaming]``
   diagnostic naming the rekey (under ``validate="off"``, the bare
   refusal);
11. gemma2: prefill of 2×8192 tokens and 32 greedy decode steps through
   ``launch.serve.dense_generate`` with every launch count set to 0 just
   before and read just after (26 launches of the tensor-core flash
   kernel, none of the FFMA kernel, no copy of q, k or v); the prefill's
   and the first decode step's logits against the same model with the
   plain attention, within ``0.02·(max|logit| + 1)``;
   a profile by kernel of one prefill (26 flash launches) and of 8 decode
   steps (none), so the main path's 26 were all its prefill's;
12. ssd: ``ssd_scan`` against ``ssd_chunked_ref`` computed in f64 (the
   exact result, :func:`exact_ssd`, as in every per-call SSD check here;
   JAX's f32 sum of C·Bᵀ is off by a few % of a row where C_i·B_i
   cancels) at the JAX kernel
   tests' cases, ragged S, S < chunk, B and C read as slices of one (B, S,
   2N) tensor (as the model hands them over) and as contiguous tensors,
   and mamba2-130m's layer shape (B=8, S=8192, H=24, P=64, N=128, L=128) —
   every bf16 case through the tensor-core kernel (``TC_LAUNCHES``), every
   f32 case through the FFMA kernel (``FFMA_LAUNCHES``): max |err| within
   ``SSD_TOL`` of the largest |output| and each output row's error within
   ``SSD_ROW_TOL`` of that row's norm; at the layer shape in bf16 the
   final state from the same launch within ``SSD_TOL`` of the largest |h|
   of ``ssd_final_state`` and within ``SSD_STATE_TOL`` of the largest |h|
   of the f64 state; timed at the layer shape, bf16 on the tensor-core
   kernel and f32 on the FFMA one, with the plain version and the bound;
   zamba2-7b's layer shape (B=2, S=8192, H=112, P=64, N=64, L=128) the
   same ways;
13. mamba2: prefill of 8×8192 tokens and 32 greedy decode steps through
   ``dense_generate`` with every launch count set to 0 just before and
   read just after (24 launches of the tensor-core SSD kernel, none of
   the FFMA one, no cast, no other kernel); in a second prefill, every
   layer's SSD call on its real inputs against the exact result, y and
   final state within the ssd phase's limits (beside them, not gated, the
   row errors of the FFMA kernel, of the plain version in f32 — the
   model's plain path, JAX's arithmetic — and of the exact y rounded to
   bf16, on the same inputs); the same weights in f32
   through the FFMA kernel (24 launches a prefill) and through the plain
   SSD scan, prefill and first decode logits within
   ``MAMBA2_F32_LOGIT_TOL``; the bf16 run's prefill and first
   decode logits against the plain-SSD run's within ``BF16_FLOOR_FACTOR``
   of the model's rounding floor, measured here as the distance between
   the plain scan in half-size chunks and in full chunks (in bf16 the
   logits move by more than ``0.02·(max|logit| + 1)`` when only the
   rounding changes: 24 layers without post-norms add up the bf16 noise
   of each); a profile by kernel of one prefill (24 SSD launches) and of
   8 decode steps (none);
14. zamba2: prefill of 2×8192 tokens and 32 greedy decode steps through
   ``dense_generate`` with every launch count set to 0 just before and
   read just after (13 launches of the tensor-core flash kernel, one per
   shared-block application, and 78 of the tensor-core SSD kernel, one
   per Mamba2 layer; none of either FFMA kernel, no copy, no cast); in
   further prefills, every Mamba2 layer's SSD call on its real inputs held
   as mamba2's are, and every shared-block application's attention on its
   real inputs held to the flash phase's exact gate and row limit (the
   plain version's and the FFMA kernel's crossings beside it); the
   same weights in f32 through the FFMA kernels against both plain
   versions, prefill and first decode logits within
   ``0.02·(max|logit| + 1)``; the bf16 run against the plain-kernels run
   within ``BF16_FLOOR_FACTOR`` of the rounding floor (both plain, the
   SSD in half-size chunks against full ones); a profile by kernel of one
   prefill (13 + 78 launches) and of 8 decode steps (none); peak memory;
15. lm_serve: ``RecurrentLM.from_config(gemma2-2b)`` at full width (d_model
   2304, vocab 256000; Wh, Wx, Wo and the embedding table drawn on the card
   from seed 0), capacity 8, through ``TraServer(Engine(device="cuda",
   executor="jit"))`` (the default ``validate``, ``"warn"``: its
   diagnostics counted) with TF32 off: 40 requests from ``lm_mix`` (prompts
   of 1-8 tokens, 1-12 new tokens) arriving by ``open_loop`` at a Poisson
   50 requests/s — the JAX launcher's documented run
   (``src/repro/launch/serve.py:3-4``) at full width — with every launch
   count set to 0 just before and read just after.  Gates: each request's
   tokens equal the oracle's (``oracle_decode``'s loop, plain f32 on the
   card) and each generated token's logits lie within the step's limit of
   the oracle's: ``tolerance(2304, f32)`` with its atol scaled by the
   step's max|h'|·max|Wo| (the unscaled form assumes unit operands; a
   logit here is ~1e-2), never above that ceiling; where the tokens part,
   the oracle's two highest logits at that step lie within that same limit
   of each other (a near-tie, counted and printed; later steps of that
   request are not compared); 1 compile and 0 cache misses after warmup;
   every hand-kernel launch count 0 (JAX's optimizer leaves the step's
   products unfused, so they run on cuBLAS); after the drain no slot is
   held and every state row is zero; a control on the logits gate: one
   full tick from a non-zero state passes the limit as served, and fails
   it with its logits from operands rounded to TF32 or to bf16 (read too:
   the served tick with ``allow_tf32`` on, and each share of the
   ceiling).
   Then the same requests again on an engine with ``check_numerics=True``
   and ``chaos_injector(site_every=7, nan_node="relu", nan_every=11)``,
   ``max_retries`` 8 (``benchmarks/resilience.py``'s budget, above the 7
   faults a 20-token request can meet): every request completes with the
   clean run's tokens, ``transient_faults`` and ``recovered`` above 0, no
   launch of a hand kernel.  Printed: ticks, host ms a tick (median, each
   tick ending in its logits' copy to the host), device ms a tick from a
   profile by kernel of 10 full ticks, the tick's bound (the three
   products' bytes, Wh + Wx + Wo = 2.40 GB, at the HBM rate), tokens/s,
   p50/p99, peak memory, the logits copied to the host a tick (8.2 MB)
   and the time of that copy and of the state snapshot, the chaos run's
   counters and extra wall time, and the card's name and power limit;
16. lm_train: first the earlier phases' memory is freed and the card's
   allocated bytes printed before and after the phase.  The flash
   backward's kernels (a dQ kernel by :func:`flash_ops.bwd_route`: bf16 up
   to 128 padded columns ``flash_attention_bwd_dq_kernel_wgmma``, else
   ``flash_attention_bwd_dq_kernel``; then
   ``flash_attention_bwd_dkdv_kernel``) against ``attention_bwd_ref``
   (autograd through the plain attention) at gemma2-2b's train shapes (B 8,
   S 128, Hq 8, Hkv 4, D 256, soft-cap 50: the window-4096 and the global
   layer; each kernel timed alone with CUDA events, beside the plain backward,
   the bounds and SDPA's backward without soft-cap), a longer gemma2-head
   case (B 1, S 2048, window 1024), a ragged S (200), GQA 4:1 and two f32
   cases: dq, dk and dv each within the forward's limits (``FLASH_TOL``
   elementwise, ``ROW_REL_TOL`` a row: bf16 1e-2, f32 1e-4), one launch of
   the routed dQ kernel and of the dK/dV kernel, and the dQ kernel's row
   statistics (LSE, D) within the f32 limits of ``attention_bwd_stats_ref``.
   Then gemma2-2b at full width (26 layers, d_model 2304,
   vocab 256000, tied embedding, random weights from seed 0) trained
   through ``repro_torch.launch.train`` (``run``: ``main``'s code, which
   also returns the trainer) for ``LM_TRAIN_STEPS`` steps of AdamW at
   batch 8 × 128 tokens (the launcher's defaults; no checkpoint written),
   with every launch count set to 0 just before and read just after: per
   step 26 launches of the tensor-core flash kernel, 26 of the FFMA dQ
   kernel (head dim 256) and 26 of the dK/dV kernel, none of the
   tensor-core dQ kernel, the FFMA forward or the SSD scan, no copy; every loss
   and grad norm finite; step 1 recomputed from the same seed and batch
   with the kernels and with the plain attention (``attn_impl="plain"``),
   the kernel run's loss within ``LM_TRAIN_LOSS_RTOL`` and its grad norm
   within ``LM_TRAIN_GNORM_RTOL`` of the plain one's.  Printed: ms a step
   (median of steps 2-6, host clock, each step ending in a synchronizing
   read of the step counter), the first step, the peak
   ``max_memory_allocated``, the bounds of the step's products (6·N·tokens
   at the bf16 peak) and of AdamW's bytes, and a profile of one more step
   by group (flash backward, flash forward, GEMMs, elementwise and AdamW,
   other) with the busy share.  Last the card restart of
   ``tests/test_runtime.py`` at the qwen2.5-14b smoke width (checkpoints
   every 2 steps, a ``SimulatedFailure`` at step 3, 6 steps): losses and
   the final master params and moments bit-equal to the uninterrupted
   run's;
17. ssm_train: the earlier phases' memory freed first, as lm_train's.  The
   four SSD backward kernels (the state passes and the chunk kernel of
   the type — bf16: ``ssd_scan_bwd_{state,dstate}_kernel_wgmma`` of
   ``csrc/ssd_scan_bwd_state_wgmma.cu`` and
   ``ssd_scan_bwd_chunk_kernel_wgmma`` of ``csrc/ssd_scan_bwd_wgmma.cu``;
   f32: ``ssd_scan_bwd_{state,dstate,chunk}_kernel`` of
   ``csrc/ssd_scan_bwd.cu`` — and ``ssd_scan_bwd_reduce_kernel`` of
   ``csrc/ssd_scan_bwd.cu``) through ``ssd_scan_bwd`` against
   ``ssd_scan_bwd_ref`` computed in f64 (autograd through the chunked
   scan), all five gradients, in bf16 and f32: the JAX kernel tests'
   cases, a ragged S (200 at chunk 128), S < chunk, the default chunk 256
   (run at 128), N and P off the tiles, B and C contiguous and strided, a
   strong decay (dt·A near -20 a step), and mamba2-130m's (B 8, S 2048,
   H 24, P 64, N 128) and zamba2-7b's (B 4, S 1024, H 112, P 64, N 64)
   layers at their train shapes — each gradient within ``SSD_TOL`` of its
   largest |value| and each row within ``SSD_ROW_TOL`` of its norm, one
   launch of each kernel (bf16: the tensor-core state passes and chunk
   kernel and no FFMA one; f32 the reverse), a second call bit-equal, and
   the state passes' S_in and G buffers against ``ssd_bwd_states_ref`` in
   f64 (:func:`ssd_bwd_state_buffers`: the f32 limits); at the two train
   layers, in bf16 and in f32, each kernel timed alone with CUDA events
   beside its bound (the function's own bytes or its operations at the
   type's peak) and its buffers' bytes, the four together and the plain
   backward; the flash backward at
   zamba2-7b's shared attention (B 4, S 1024, 32 heads of 112, causal)
   against ``attention_bwd_ref`` (the tensor-core dQ kernel, its LSE and D
   against ``attention_bwd_stats_ref``; timed beside the FFMA dQ kernel).
   Then mamba2-130m at full width and
   depth (24 layers, d_model 768, vocab 50280, N 128) through
   ``repro_torch.launch.train``'s ``run`` at batch 8 × 2048 (16 chunks a
   row), and zamba2-7b at full width cut to 12 Mamba2 layers (2 groups
   of 6, each shared block applied once; d_model 3584, 112 SSD heads,
   N 64, 32 attention heads of 112, d_ff 14336, vocab 32000) through
   ``runtime.Trainer`` as the launcher builds it, at batch 4 × 1024: each
   6 AdamW steps with every launch count set to 0 just before and read
   just after — per step one SSD forward (tensor-core kernel) and one
   launch of each backward kernel a Mamba2 layer (the state passes and
   the chunk kernel the tensor-core ones, the FFMA ones never), for
   zamba2 also one
   flash forward, one tensor-core dQ launch (no FFMA one) and one dK/dV
   launch a shared-block application, no cast, copy or other kernel; every loss and grad norm
   finite; step 1 recomputed from weight seeds 0, 1 and 2
   (:func:`ssd_step_one`): in bf16 each gradient leaf on the kernels
   within ``SSD_TRAIN_FLOOR_FACTOR`` floors of the plain SSD scan's
   (``ssd_impl="plain"``), each leaf's floor read in the same run from
   the plain scan in f64 and in half chunks, and the loss within
   ``LM_TRAIN_LOSS_RTOL`` of it; the loss and the grad norm within
   ``LM_TRAIN_LOSS_RTOL`` and ``LM_TRAIN_GNORM_RTOL`` in bf16 against
   the kernels' own forward with the plain backward, and in f32 (the same
   config) against the plain SSD (the bf16 grad norm against the plain
   SSD's printed, not gated: rounding alone moves it by several %).
   Printed for
   each: ms a step (median of steps 2-6, host clock), the first step, the
   peak ``max_memory_allocated``, the bounds (6·N·tokens at the bf16 peak,
   AdamW's bytes), a profile of one more step by group (SSD backward, SSD
   forward, flash backward and forward, GEMMs, elementwise and AdamW,
   other) with the busy share.  Last the card restart at the mamba2
   smoke width (40 tokens a row: the state crosses two chunk boundaries),
   held bit for bit as lm_train's;
18. the kernels line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without a CUDA
device the script exits non-zero at once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.ffnn_paper import speech  # noqa: E402
from repro_torch.core import TraTrainer  # noqa: E402
from repro_torch.core.cost import H100_SXM  # noqa: E402
from repro_torch.core.plan import FusedJoinAgg, postorder  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref, attention_bwd_stats_ref, attention_ref)
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.matmul.ref import (matmul_ref,  # noqa: E402
                                            splitk_reduce_ref,
                                            tf32_split_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402
from repro_torch.store.stream import StreamExecutor, _rebuild  # noqa: E402
from repro_torch.models.model import (_window_for, group_size,  # noqa: E402
                                      n_scan_groups)

SEED = 0
N_REQUESTS = 64
ARRIVAL_RATE = 2000.0            # requests/s, Poisson
BUCKETS = (1, 2, 4, 8)
ARCH = "gemma2-2b"
PROMPT_BATCH, PROMPT_LEN, GEN = 2, 8192, 32
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# At S=8192 an output is a softmax average over thousands of keys, ~0.02,
# so 3e-2 would hold nothing there.  The gemma2 bf16 shapes are held to the
# exact attention (f64) instead: every output within half a bf16 step of
# the exact value, the step taken at the larger of the two magnitudes, plus
# GEMMA2_BF16_DELTA, 3x the largest excess over half a step that the card
# read at those shapes (tools/flash_gate_census.py on an H100: 1.85e-6 for
# the wgmma kernel over 64 draws at S=256 and 8 at S=8192 of each layer
# kind; 7.3e-7 for the f32 FFMA kernel).  A correct kernel rounds an f32
# result that lies within a few 1e-6 of the exact value, so it may land on
# either bf16 neighbour of a value near their midpoint, and this gate
# passes both; a limit against the plain version's bf16 output (the former
# GEMMA2_BF16_ATOL, 6e-3) failed correct kernels on some draws, one step
# apart.  With delta below 6e-3 the new limit, half a step plus delta,
# lies below the former one, 6e-3 plus the plain output's own half step,
# at every magnitude.  Every case also keeps the limit on the largest
# error of one output row over that row's norm.
GEMMA2_BF16_DELTA = 5.6e-6
GEMMA2_BF16_ATOL = 6e-3          # the former gate: tools/flash_gate_census.py
ROW_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The bf16 tensor-core kernel must round like an f32 computation: at
# gemma2's head shape (first 256 rows, where outputs reach 1 and more) the
# outputs that differ from the correctly rounded f64 attention may number
# at most FLASH_ROUNDING_FACTOR times the plain f32 version's.  In a
# plain-torch model of the kernel's arithmetic, P in one or two bf16 terms
# fails this and three pass (tests/test_torch_flash_attention.py).
FLASH_ROUNDING_FACTOR = 2.0
# The tensor-core dQ kernel's dS enters dQ += dS·K in the fewest bf16 terms
# that keep its dq within this share of each bf16 limit (FLASH_TOL
# elementwise, ROW_REL_TOL a row) on every case it runs; one term fewer
# passes the limits themselves but not this share
# (tests/test_torch_flash_backward_tc.py), so the card holds it too.
BWD_TC_DQ_SHARE = 0.5
SSM_ARCH = "mamba2-130m"
SSM_BATCH = 8                    # x PROMPT_LEN tokens, GEN decode steps
# An SSD output sums terms of either sign over the chunk and the carried
# state (|C·B| ~ √N), so its rounding error scales with the largest output,
# not with its own size.  At the mamba2-130m layer shape this script read,
# on an H100 80GB HBM3 at 700 W, max |err| 1.2e-5·max|ref| and a row error
# of 1.3e-4 of the row's norm in f32, one bf16 step (2^-9 of max|ref|) and
# 3.1e-3 in bf16.  Limits: max |err| within SSD_TOL·max|ref| (f32 8x that, bf16 above
# one step at the top output, 2^-7); row error within SSD_ROW_TOL (f32 8x,
# bf16 3x).  tests/test_torch_ssd_scan.py shows they catch a chunk boundary
# one step off, a dropped carried state and a decay 1% off.
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_ROW_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
# The final state is f32 in both dtypes, and the decode starts from it.
# ssd_final_state (JAX's op) is itself 7.4e-4 of max|h| off the f64 state
# on mamba2-130m's real inputs (an f32 cumsum over 8192 steps), so besides
# SSD_TOL against it the kernel's state is held to the f64 state: within
# SSD_STATE_TOL of the largest |h|.  This script read 2.2e-6 at the layer
# shape and 2.2e-5 on the real inputs (H100 80GB HBM3 at 700 W); a state
# rounded to bf16 lies ~2e-3 off.
SSD_STATE_TOL = 1e-4
# mamba2-130m end to end.  In f32 the kernel run's prefill and first decode
# logits lay 1.2e-3 and 2.0e-3 from the plain-SSD run's (this script, H100
# 80GB HBM3 at 700 W): the f32 limit is 10x the larger.  In bf16 this random
# 24-layer model moves its logits by more than 0.02·(max|logit| + 1) when
# only the rounding changes, so the bf16 run is held within
# BF16_FLOOR_FACTOR of that rounding floor, measured in the same run.
MAMBA2_F32_LOGIT_TOL = 2e-2
BF16_FLOOR_FACTOR = 1.5
# zamba2-7b at full width: 78 Mamba2 layers in 13 groups of 6, each group
# followed by one of 2 shared attention + MLP blocks; 2 x PROMPT_LEN tokens
# (its SSD layer: 112 heads of two-head CTAs per batch row, 112 CTAs).  The
# f32 run is held within 0.02·(max|logit| + 1) of the plain versions'
# (tests/test_arch_smoke.py:96-98), the bf16 run within BF16_FLOOR_FACTOR
# of its rounding floor, as mamba2's.
HYBRID_ARCH = "zamba2-7b"
HYBRID_BATCH = 2
PEAK = {torch.float32: H100_SXM.peak_flops_f32,
        torch.bfloat16: H100_SXM.peak_flops}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cublas_warm(device) -> int:
    """One small product on the current stream; the bytes it leaves
    allocated.  torch keeps a cuBLAS workspace for each stream from its
    first product to the end of the process, so a phase that checks that
    it frees every byte it allocates calls this before it reads its
    baseline: the check then holds whether or not a phase ran before it."""
    before = torch.cuda.memory_allocated(device)
    a = torch.ones(16, 16, device=device)
    (a @ a).sum().item()
    del a
    return torch.cuda.memory_allocated(device) - before


def phase_allocated(device) -> int:
    """Bytes allocated on the card less those the matmul ops keep for the
    process by design: the fold tickets, one zeroed buffer a stream made
    at the stream's first split-K launch (``mm_ops._TICKETS``).  A phase
    that checks that it frees every byte it allocates reads this before
    and after, so the check holds whether or not a phase ran before it."""
    kept = sum(t.numel() * t.element_size()
               for (index, _), t in mm_ops._TICKETS.items()
               if index == device.index)
    return torch.cuda.memory_allocated(device) - kept


def tile_kernel(a, b):
    """f32 ``a @ b`` (2-D) on the tile kernel and its split-K pass, whatever
    the op's route: the products the skinny, tensor-core and narrow routes
    took over, timed and checked on the kernel they replaced."""
    return mm_ops._launch_tile(a, b, a.shape[0], a.shape[1], b.shape[1],
                               torch.float32)


def timed_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_per_call(fn, calls: int = 10) -> float:
    """Device time of one ``fn()``: the kernels it launches, summed over
    ``calls`` calls under ``torch.profiler`` and divided by them.  Beside
    ``timed_ms``, which a call whose host work outlasts its kernels reads
    as the host's time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / calls


def bound_times(m: int, k: int, n: int, dtype, route: str = "") -> tuple:
    """(bytes_ms, operations_ms) of a product on an H100 SXM (data sheet):
    each input read once and the output written once at the HBM rate,
    against the operations at the type's peak — for f32 on the
    tensor-core route (``route="tc"``) three TF32 products at the tensor
    cores' TF32 rate, else one product at the FFMA rate.  The bound is the
    larger."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (m * k + k * n + m * n) * isz
    flops = 2.0 * m * n * k
    ops_ms = (3 * flops / H100_SXM.peak_flops_tf32 if route == "tc"
              else flops / PEAK[dtype]) * 1e3
    return nbytes / H100_SXM.hbm_bw * 1e3, ops_ms


def split_bound_times(m: int, k: int, n: int) -> tuple:
    """(bytes_ms, operations_ms) of the two split passes of an (m, k) @
    (k, n) product on the tensor-core route: each operand read once and
    its two TF32 terms written once (K padded), against two roundings and
    a subtraction a value at the f32 peak."""
    kp = mm_ops.tc_kp(k)
    nbytes = (m * k + k * n + 2 * (m + n) * kp) * 4
    return (nbytes / H100_SXM.hbm_bw * 1e3,
            3.0 * (m * k + k * n) / PEAK[torch.float32] * 1e3)


def reduce_bound_times(splits: int, m: int, n: int) -> tuple:
    """(bytes_ms, operations_ms) of the split-K reduction: the f32 partial
    sums read once and the f32 output written once; one add per partial."""
    return ((splits + 1) * m * n * 4 / H100_SXM.hbm_bw * 1e3,
            splits * m * n / PEAK[torch.float32] * 1e3)


def bound_of(t_bytes: float, t_ops: float) -> tuple:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tolerance(k: int, dtype) -> tuple:
    """(rtol, atol): f32 as tests/test_kernels.py (1e-5, 1e-5·√K), with rtol
    widened to 1e-4 at K >= 100000, where the kernel's split-K order and the
    library's order differ over many more terms; bf16 2e-2 (same form)."""
    if dtype == torch.bfloat16:
        return 2e-2, 2e-2 * math.sqrt(k)
    rtol = 1e-4 if k >= 100_000 else 1e-5
    return rtol, 1e-5 * math.sqrt(k)


def reset_launches() -> None:
    mm_ops.LAUNCHES = mm_ops.REDUCE_LAUNCHES = flash_ops.LAUNCHES = 0
    flash_ops.BWD_DQ_LAUNCHES = flash_ops.BWD_DKDV_LAUNCHES = 0
    flash_ops.BWD_DQ_TC_LAUNCHES = flash_ops.BWD_DQ_FFMA_LAUNCHES = 0
    mm_ops.SKINNY_LAUNCHES = mm_ops.FOLDS = mm_ops.COPIES = 0
    mm_ops.TC_LAUNCHES = mm_ops.SPLIT_LAUNCHES = 0
    mm_ops.NARROW_LAUNCHES = mm_ops.NARROW_FOLDS = 0
    flash_ops.TC_LAUNCHES = flash_ops.FFMA_LAUNCHES = flash_ops.COPIES = 0
    ssd_ops.LAUNCHES = ssd_ops.TC_LAUNCHES = ssd_ops.FFMA_LAUNCHES = 0
    ssd_ops.COPIES = ssd_ops.BWD_LAUNCHES = 0
    for _, counter in ssd_ops.BWD_KERNELS:
        setattr(ssd_ops, counter, 0)
    for routes in ssd_ops.BWD_ROUTED.values():
        for _, counter in routes.values():
            setattr(ssd_ops, counter, 0)


def read_launches() -> dict:
    """Every kernel's launch count (``flash_attention`` and ``ssd_scan``
    are the sums of their forward and backward kernels',
    ``flash_attention_bwd_dq`` of the two dQ kernels' (``_tc``, ``_ffma``),
    ``ssd_scan_bwd``
    of the four SSD backward kernels', ``ssd_scan_bwd_state``,
    ``_dstate`` and ``_chunk`` of each one's two routes' (``_tc`` bf16,
    ``_ffma`` f32)), the skinny and narrow matmul
    launches that folded a split-K sum, and the copies of operands the
    matmul, flash and SSD ops made."""
    return {"matmul_skinny": mm_ops.SKINNY_LAUNCHES,
            "matmul_fold": mm_ops.FOLDS,
            "matmul_copies": mm_ops.COPIES,
            "matmul": mm_ops.LAUNCHES,
            "matmul_splitk_reduce": mm_ops.REDUCE_LAUNCHES,
            "matmul_tc": mm_ops.TC_LAUNCHES,
            "matmul_tf32_split": mm_ops.SPLIT_LAUNCHES,
            "matmul_narrow": mm_ops.NARROW_LAUNCHES,
            "matmul_narrow_fold": mm_ops.NARROW_FOLDS,
            "flash_attention": flash_ops.LAUNCHES,
            "flash_attention_wgmma": flash_ops.TC_LAUNCHES,
            "flash_attention_ffma": flash_ops.FFMA_LAUNCHES,
            "flash_attention_bwd_dq": flash_ops.BWD_DQ_LAUNCHES,
            "flash_attention_bwd_dq_tc": flash_ops.BWD_DQ_TC_LAUNCHES,
            "flash_attention_bwd_dq_ffma": flash_ops.BWD_DQ_FFMA_LAUNCHES,
            "flash_attention_bwd_dkdv": flash_ops.BWD_DKDV_LAUNCHES,
            "flash_copies": flash_ops.COPIES,
            "ssd_scan": ssd_ops.LAUNCHES,
            "ssd_scan_wgmma": ssd_ops.TC_LAUNCHES,
            "ssd_scan_ffma": ssd_ops.FFMA_LAUNCHES,
            "ssd_scan_bwd": ssd_ops.BWD_LAUNCHES,
            **{f"ssd_scan_bwd_{name}": getattr(ssd_ops, counter)
               for name, counter in ssd_ops.BWD_KERNELS},
            **{f"ssd_scan_bwd_{name}_{route}": getattr(ssd_ops, counter)
               for name, routes in ssd_ops.BWD_ROUTED.items()
               for route, (_, counter) in routes.items()},
            "ssd_copies": ssd_ops.COPIES}


def launches_of(**nonzero) -> dict:
    """The counts a path should read: 0 but where given."""
    return {**{name: 0 for name in read_launches()}, **nonzero}


# ---------------------------------------------------------------- phases
def phase_device(device) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build() -> None:
    """Every kernel library at once, each source by its own ``nvcc``, all
    in parallel; then the ``HGMMA`` counts of the flash, SSD and matmul
    libraries and of the tensor-core dQ kernel alone, and the ``UTMALDG``
    count of the matmul library."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        seconds = dict(zip(build.SOURCES, pool.map(build.build,
                                                   build.SOURCES)))
    for name in build.SOURCES:
        usage = [ln.strip() for ln in build.BUILD_LOGS.get(name, "")
                 .splitlines() if "registers" in ln or "spill" in ln
                 or "Performance" in ln]
        emit({"phase": "build", "library": name, "seconds": seconds[name],
              "ptxas": usage})
    hgmma = build.sass_count("flash_attention", "HGMMA")
    dq_hgmma = build.sass_count("flash_attention", "HGMMA",
                                "flash_attention_bwd_dq_kernel_wgmma")
    ssd_hgmma = build.sass_count("ssd_scan", "HGMMA")
    utmaldg = build.sass_count("matmul", "UTMALDG")
    mm_hgmma = build.sass_count("matmul", "HGMMA")
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "flash_attention_hgmma": hgmma,
          "flash_attention_bwd_dq_wgmma_hgmma": dq_hgmma,
          "ssd_scan_hgmma": ssd_hgmma,
          "matmul_hgmma": mm_hgmma, "matmul_utmaldg": utmaldg})
    if hgmma == 0:
        fail("build: no HGMMA instruction in the flash library's SASS")
    if dq_hgmma == 0:
        fail("build: no HGMMA instruction in flash_attention_bwd_dq_kernel_"
             "wgmma's SASS")
    if ssd_hgmma == 0:
        fail("build: no HGMMA instruction in the SSD library's SASS")
    if utmaldg == 0:
        fail("build: no UTMALDG (TMA load) in the matmul library's SASS")
    if mm_hgmma == 0:
        fail("build: no HGMMA instruction in the matmul library's SASS")


def kernel_case(m, k, n, dtype, device, gen, iters) -> dict:
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    b = torch.randn((k, n), generator=gen, device=device).to(dtype)
    out = mm_ops.matmul(a, b, impl="kernel")
    ref = matmul_ref(a, b)
    torch.cuda.synchronize(device)
    if out.shape != (m, n) or out.dtype != dtype:
        fail(f"matmul {m}x{k}x{n} {dtype}: got {tuple(out.shape)} "
             f"{out.dtype}")
    rtol, atol = tolerance(k, dtype)
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if not bool(torch.isfinite(o).all()) or bool(
            (err > atol + rtol * r.abs()).any()):
        fail(f"matmul {m}x{k}x{n} {dtype}: max |err| {err.max().item()} "
             f"over rtol={rtol} atol={atol}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    route = mm_ops.route(a, b, "kernel")
    t_bytes, t_ops = bound_times(m, k, n, dtype, route)
    bnd, by = bound_of(t_bytes, t_ops)
    row = {"m": m, "k": k, "n": n, "dtype": str(dtype).split(".")[-1],
           "route": route,
           "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol,
           "kernel_ms": timed_ms(lambda: mm_ops.matmul(a, b, impl="kernel"),
                                 device, iters),
           "plain_ms": timed_ms(lambda: matmul_ref(a, b), device, iters),
           "library_ms": timed_ms(lambda: torch.matmul(a, b), device,
                                  iters),
           "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
           "operations_ms": t_ops,
           "tile_splits": mm_ops.plan_launch(m, n, k, sms)[1]}
    if route in ("skinny", "tc"):
        # the products the skinny kernel and the tensor-core route took
        # over, on the tile kernel
        tile = tile_kernel(a, b).float()
        terr = (tile - r).abs()
        if not bool(torch.isfinite(tile).all()) or bool(
                (terr > atol + rtol * r.abs()).any()):
            fail(f"matmul tile kernel {m}x{k}x{n}: max |err| "
                 f"{terr.max().item()} over rtol={rtol} atol={atol}")
        row["tile_max_abs_err"] = terr.max().item()
    return row


def reduce_case(m, k, n, device, gen, iters) -> dict:
    """The split-K reduction at the partial sums of an (m, k) @ (k, n)
    product: as many splits as the matmul takes there.  The kernel adds in
    the plain version's order, so the two agree to the bit; the check
    allows 1e-6."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = mm_ops.plan_launch(m, n, k, sms)[1]
    if splits < 2:
        fail(f"splitk_reduce: {m}x{k}x{n} takes no split-K")
    partial = torch.randn((splits, m, n), generator=gen, device=device)
    out = mm_ops.splitk_reduce(partial, impl="kernel")
    ref = splitk_reduce_ref(partial)
    torch.cuda.synchronize(device)
    err = (out - ref).abs()
    if out.shape != (m, n) or not bool(torch.isfinite(out).all()) or bool(
            (err > 1e-6 + 1e-6 * ref.abs()).any()):
        fail(f"splitk_reduce {splits}x{m}x{n}: shape {tuple(out.shape)}, "
             f"max |err| {err.max().item()} over rtol=atol=1e-6")
    t_bytes, t_ops = reduce_bound_times(splits, m, n)
    bnd, by = bound_of(t_bytes, t_ops)
    return {"splits": splits, "m": m, "n": n, "of_product_k": k,
            "max_abs_err": err.max().item(), "rtol": 1e-6, "atol": 1e-6,
            "kernel_ms": timed_ms(
                lambda: mm_ops.splitk_reduce(partial, impl="kernel"),
                device, iters),
            "plain_ms": timed_ms(lambda: splitk_reduce_ref(partial), device,
                                 iters),
            "library_ms": timed_ms(lambda: partial.sum(0), device, iters),
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops}


def phase_kernels(device, d_in, d_hidden, d_out, gen) -> tuple:
    shapes = [(128, 128, 128), (256, 512, 128), (384, 256, 640)]
    cases = [(m, k, n, dt) for m, k, n in shapes
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(100, 70, 50, torch.float32), (100, 70, 50, torch.bfloat16)]
    # the scorer's two products at the smallest and largest bucket
    for b in (1, 8):
        cases += [(b, d_in, d_hidden, torch.float32),
                  (b, d_hidden, d_out, torch.float32)]
    rows = []
    for m, k, n, dt in cases:
        rows.append(kernel_case(m, k, n, dt, device, gen, iters=20))
        emit({"phase": "kernel", "name": "matmul", **rows[-1]})
    reduce_rows = []
    for b in (1, 8):
        reduce_rows.append(reduce_case(b, d_hidden, d_out, device, gen,
                                       iters=20))
        emit({"phase": "kernel", "name": "matmul_splitk_reduce",
              **reduce_rows[-1]})
    return rows, reduce_rows


def blocked_case(m, blocks, device, gen) -> dict:
    """The skinny kernel on the (r0·r1, c0·c1) matrix held as the permuted
    view (r0, r1, c0, c1) of a (r0, c0, r1, c1) tensor — how the engine
    hands over a blocked relation — against ``matmul_ref`` on the same
    values made contiguous: read in place, with no copy."""
    r0, r1, c0, c1 = blocks
    k = r0 * r1
    w = torch.randn((r0, c0, r1, c1), generator=gen, device=device)
    view = w.permute(0, 2, 1, 3)
    a = torch.randn((m, k), generator=gen, device=device)
    dense = view.reshape(k, c0 * c1)
    before = (mm_ops.SKINNY_LAUNCHES, mm_ops.COPIES)
    out = mm_ops.matmul(a, view, b_rows=2)
    ref = matmul_ref(a, dense)
    torch.cuda.synchronize(device)
    launched = mm_ops.SKINNY_LAUNCHES - before[0]
    copies = mm_ops.COPIES - before[1]
    rtol, atol = tolerance(k, torch.float32)
    err = (out - ref).abs()
    if launched != 1 or copies != 0 or not bool(torch.isfinite(out).all()) \
            or bool((err > atol + rtol * ref.abs()).any()):
        fail(f"skinny matmul on the view {blocks}, m={m}: {launched} "
             f"launches, {copies} copies, max |err| {err.max().item()} "
             f"over rtol={rtol} atol={atol}")
    return {"case": "blocked view in place", "m": m, "view": list(blocks),
            "copies": copies, "max_abs_err": err.max().item(),
            "rtol": rtol, "atol": atol}


def copied_case(device, gen) -> dict:
    """An operand that starts off a 16-byte boundary: copied once,
    counted, and the product still right."""
    base = torch.randn(1600 * 1000 + 1, generator=gen, device=device)
    b = base[1:].view(1600, 1000)
    a = torch.randn((8, 1600), generator=gen, device=device)
    before = mm_ops.COPIES
    out = mm_ops.matmul(a, b)
    ref = matmul_ref(a, b)
    torch.cuda.synchronize(device)
    rtol, atol = tolerance(1600, torch.float32)
    err = (out - ref).abs()
    if mm_ops.COPIES - before != 1 or bool(
            (err > atol + rtol * ref.abs()).any()):
        fail(f"skinny matmul, B off 16 bytes: {mm_ops.COPIES - before} "
             f"copies (1 expected), max |err| {err.max().item()}")
    return {"case": "B off 16 bytes, copied", "m": 8, "k": 1600, "n": 1000,
            "copies": mm_ops.COPIES - before,
            "max_abs_err": err.max().item(), "rtol": rtol, "atol": atol}


def fold_case(m, k, n, device, gen) -> dict:
    """The skinny kernel's fold against ``splitk_reduce_ref`` on the
    partial tiles the same launch wrote: equal to the bit."""
    a = torch.randn((m, k), generator=gen, device=device)
    b = torch.randn((k, n), generator=gen, device=device)
    out, partials = mm_ops._launch_skinny(a, b, 1, 1, m, k, n, torch.float32,
                                          keep_partials=True)
    torch.cuda.synchronize(device)
    if partials is None:
        fail(f"skinny matmul {m}x{k}x{n}: K was not split")
    ref = splitk_reduce_ref(partials)
    err = (out - ref).abs().max().item()
    if not torch.equal(out, ref):
        fail(f"skinny fold {m}x{k}x{n}: differs from splitk_reduce_ref of "
             f"its {partials.shape[0]} partial tiles by {err}")
    return {"case": "fold vs splitk_reduce_ref of its partials", "m": m,
            "k": k, "n": n, "splits": partials.shape[0],
            "max_abs_err": err, "rtol": 0.0, "atol": 0.0}


def phase_skinny(device, d_in, d_hidden, d_out) -> list:
    """The skinny kernel's own cases, from a generator of their own."""
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    rows = [blocked_case(8, (4, d_in // 4, 10, 1000), device, gen),
            blocked_case(3, (3, 100, 5, 1000), device, gen),
            blocked_case(8, (10, d_hidden // 10, 1, d_out), device, gen),
            copied_case(device, gen)]
    for b in (1, 8):
        rows.append(fold_case(b, d_hidden, d_out, device, gen))
    rows.append(fold_case(8, d_in, 4000, device, gen))
    for row in rows:
        emit({"phase": "kernel", "name": "matmul_skinny", **row})
    return rows


def make_scorer(device):
    from repro_torch.serve import FFNNScorer
    cfg = speech(100_000)
    db, hb, lb = 4, 10, 1          # db, hb > 2: both products fuse
    return FFNNScorer(db=db, hb=hb, lb=lb, bd=cfg.d_in // db,
                      bh=cfg.d_hidden // hb, bl=cfg.d_out // lb,
                      buckets=BUCKETS, seed=SEED, device=device)


def phase_serve(device) -> dict:
    from repro_torch.core import Engine
    from repro_torch.serve import (TraServer, open_loop, poisson_arrivals,
                                   scorer_mix)
    t0 = time.perf_counter()
    scorer = make_scorer(device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    engine = Engine(executor="jit", device=device, validate="strict")
    server = TraServer(engine, scorer)
    t0 = time.perf_counter()
    artifacts = server.warmup()
    warmup_s = time.perf_counter() - t0
    for aid, compiled in artifacts.items():
        fused = sum(isinstance(n, FusedJoinAgg)
                    for n in postorder(compiled.plan))
        if fused != 2:
            fail(f"artifact {aid}: {fused} FusedJoinAgg nodes, expected 2"
                 f"\n{compiled.describe()}")
    rng = np.random.default_rng(SEED)
    payloads = scorer_mix(scorer, rng, N_REQUESTS)
    arrivals = poisson_arrivals(rng, N_REQUESTS, ARRIVAL_RATE)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    report = open_loop(server, payloads, arrivals)
    launches = read_launches()
    # ---------------------------------------------------------------------

    dispatches = sum(server.dispatches.values())
    if report.errors or report.shed:
        fail(f"serve: {report.errors} errors, {report.shed} shed")
    if server.cache_misses_since_warmup != 0:
        fail(f"serve: {server.cache_misses_since_warmup} cache misses "
             f"after warmup")
    # per dispatch: both products launch the skinny kernel, reading the
    # blocked weights in place; the second, (b x 100000) @ (100000 x 10),
    # splits K and folds the partial sums in its own launch: no tile
    # kernel, no separate reduction, no copy
    expected = launches_of(matmul_skinny=2 * dispatches,
                           matmul_fold=dispatches)
    if launches != expected:
        fail(f"serve: launches {launches} for {dispatches} dispatches, "
             f"expected {expected}")
    worst = 0.0
    for p, r in zip(payloads, report.results):
        want = scorer.oracle(p)
        r = np.asarray(r)
        if r.shape != (scorer.d_out,) or not np.all(np.isfinite(r)):
            fail(f"serve: response of shape {r.shape} / not finite")
        worst = max(worst, float(np.max(np.abs(r - want))))
    if worst > 1e-4:
        fail(f"serve: responses differ from the oracle by {worst} > 1e-4")
    summary = report.summary
    out = {"phase": "serve", "width": [scorer.d_in, scorer.hb * scorer.bh,
                                       scorer.d_out],
           "blocking": {"db": scorer.db, "hb": scorer.hb, "lb": scorer.lb,
                        "bd": scorer.bd, "bh": scorer.bh, "bl": scorer.bl},
           "requests": report.requests, "arrival_rate_per_s": ARRIVAL_RATE,
           "requests_per_s": report.requests / summary["window_s"],
           "wall_s": report.wall_s,
           "p50_ms": summary["total_ms"]["p50"],
           "p99_ms": summary["total_ms"]["p99"],
           "queue_wait_p50_ms": summary["queue_wait_ms"]["p50"],
           "service_p50_ms": summary["service_ms"]["p50"],
           "dispatches": dispatches,
           "dispatches_by_artifact": dict(server.dispatches),
           "launches": launches, "max_abs_err_vs_oracle": worst,
           "cache_misses_since_warmup": server.cache_misses_since_warmup,
           "diagnostics": diag_counts(engine),
           "setup_s": setup_s, "warmup_s": warmup_s}
    out.update(dispatch_breakdown(server, scorer, device))
    emit(out)
    return out


def dispatch_breakdown(server, scorer, device) -> dict:
    """One bucket-8 dispatch timed whole (host clock, synchronized); the
    copy that arranged the blocked W1 into a 2-D operand on the parent tree
    (the path no longer makes it); and each of the dispatch's two products
    timed as the engine calls the matmul op — the same views of the
    relations' tensors — beside ``torch.matmul`` and the tile kernel (the
    parent's path) on the copied 2-D operands, and the bound."""
    bucket = max(scorer.buckets)
    compiled = server.engine.compile(scorer.program(bucket))
    rng = np.random.default_rng(SEED + 1)
    inputs = {**scorer.pack([scorer.random_payload(rng)
                             for _ in range(bucket)], bucket),
              **scorer.weights()}

    def dispatch():
        compiled.run(**inputs)["scores"].data.cpu()

    for _ in range(2):
        dispatch()
    t0 = time.perf_counter()
    iters = 10
    for _ in range(iters):
        dispatch()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    w1 = scorer.weights()["scorer.W1"].data
    db, hb, bd, bh = w1.shape
    copy_ms = timed_ms(lambda: w1.permute(0, 2, 1, 3).reshape(db * bd,
                                                             hb * bh),
                       device, iters=10)

    # the operands the engine hands the matmul op in one dispatch
    calls, real = [], mm_ops.matmul

    def spy(a, b, **kw):
        calls.append((a, b, kw))
        return real(a, b, **kw)

    mm_ops.matmul = spy
    try:
        dispatch()
    finally:
        mm_ops.matmul = real
    if len(calls) != 2:
        fail(f"dispatch_breakdown: {len(calls)} matmul calls, expected 2")
    products = []
    for (a, b, kw), name in zip(calls, ("first", "second")):
        m = math.prod(a.shape[:kw["a_rows"]])
        k = math.prod(a.shape[kw["a_rows"]:])
        n = math.prod(b.shape[kw["b_rows"]:])
        a2, b2 = a.reshape(m, k).contiguous(), b.reshape(k, n).contiguous()
        before = mm_ops.COPIES
        out = mm_ops.matmul(a, b, **kw)
        ref = matmul_ref(a2, b2)
        tile = tile_kernel(a2, b2)
        torch.cuda.synchronize(device)
        rtol, atol = tolerance(k, torch.float32)
        for what, o in (("in place", out), ("tile kernel", tile)):
            err = (o - ref).abs()
            if bool((err > atol + rtol * ref.abs()).any()):
                fail(f"{name} product {what}: max |err| {err.max().item()}")
        if mm_ops.COPIES != before:
            fail(f"{name} product: the matmul op copied an operand")
        t_bytes, t_ops = bound_times(m, k, n, torch.float32)
        bnd, by = bound_of(t_bytes, t_ops)
        timed = {"in_place": lambda: mm_ops.matmul(a, b, **kw),
                 "torch_matmul_on_copy": lambda: torch.matmul(a2, b2),
                 "tile_kernel_on_copy": lambda: tile_kernel(a2, b2),
                 "plain": lambda: matmul_ref(a2, b2)}
        products.append({
            "product": name, "m": m, "k": k, "n": n,
            "b_view": {"shape": list(b.shape), "strides": list(b.stride())},
            **{f"{what}_ms": timed_ms(fn, device, iters=20)
               for what, fn in timed.items()},
            **{f"{what}_device_ms": device_ms_per_call(fn)
               for what, fn in timed.items()},
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops,
            "max_abs_err": (out - ref).abs().max().item()})
    return {"dispatch_b8_host_ms": host_ms, "w1_permute_copy_ms": copy_ms,
            "w1_bytes": w1.numel() * w1.element_size(),
            "products_b8": products}


# ------------------------------------------------------------- training
TRAIN_STEPS = 5
TRAIN_BLOCKS = (10, 4, 10, 1)    # nb, db, hb, lb: W1 blocked as the scorer's
#: AdamW's rate on the main path.  benchmarks/train.py's 1e-2 moves every
#: weight by ~1e-2 a step, which at D 1600 and H 100000 sends the loss up
#: tenfold (tools/ffnn_train_rates.py: of 1e-2 down to 1e-5 only 3e-5 and
#: 1e-5 lower it over 5 steps, only 1e-5 at every step)
TRAIN_LR = 1e-5
#: the rates of the step-1 checks: benchmarks/train.py's AdamW, whose first
#: update (lr·sign(g)) is far above the gradients' atol, and the paper's η
CHECK_LR = 1e-2
SGD_LR = 0.01
#: the path's name in the kernels line
TRAIN_PATH = "ffnn-train-speech-100k"
#: AdamW's first update is about lr·sign(g): its W' is held only where the
#: reference |g| exceeds this many times the gradient's atol
ADAM_GATE_ATOLS = 100.0
GEMM_NAMES = ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")
MODEL_GROUPS = (("flash_attention", ("flash_attention_kernel",)),
                ("ssd_scan", ("ssd_scan_kernel",)), ("gemm", GEMM_NAMES))
TRAIN_GROUPS = (("matmul_tc", ("matmul_tc_kernel",)),
                ("tf32_split", ("tf32_split_kernel",)),
                ("matmul_narrow", ("matmul_narrow_kernel",)),
                ("matmul_tile", ("matmul_tile_kernel",)),
                ("splitk_reduce", ("splitk_reduce_kernel",)),
                ("matmul_skinny", ("matmul_skinny_kernel",)),
                ("gemm", GEMM_NAMES), ("copy", ("copy",)),
                ("elementwise", ("elementwise",)))


@contextlib.contextmanager
def plain_matmul():
    """Every matmul op call inside takes the op's plain version: the
    reference run of the train phase only (the main path never does)."""
    real = mm_ops.matmul
    mm_ops.matmul = lambda a, b, **kw: real(a, b, **{**kw, "impl": "plain"})
    try:
        yield
    finally:
        mm_ops.matmul = real


def train_problem(device):
    """The §5.3 FFNN at speech-100k, not cut: dims for
    ``ffnn_train_step_tra`` and the dense X, Y, W1, W2, drawn on the card
    as ``benchmarks/train.py`` draws them (X normal, Y = sigmoid(X·Wt),
    W1 and W2 scaled by D^-1/2 and H^-1/2)."""
    cfg = speech(100_000)
    nb, db, hb, lb = TRAIN_BLOCKS
    n, d, h, l_ = cfg.batch, cfg.d_in, cfg.d_hidden, cfg.d_out
    dims = (nb, db, hb, lb, n // nb, d // db, h // hb, l_ // lb)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((n, d), generator=gen, device=device)
    wt = torch.randn((d, l_), generator=gen, device=device) * 0.5
    y = torch.sigmoid(x @ wt)
    w1 = torch.randn((d, h), generator=gen, device=device) * d ** -0.5
    w2 = torch.randn((h, l_), generator=gen, device=device) * h ** -0.5
    return cfg, dims, {"X": x, "Y": y, "W1": w1, "W2": w2}


def train_relations(dims, dense) -> tuple:
    """(data, params): the dense tensors blocked as the program's inputs."""
    from repro_torch.core import from_tensor
    nb, db, hb, lb, bn, bd, bh, bl = dims
    tiles = {"X": (bn, bd), "Y": (bn, bl), "W1": (bd, bh), "W2": (bh, bl)}
    rel = {k: from_tensor(dense[k], t) for k, t in tiles.items()}
    return ({k: rel[k] for k in ("X", "Y")},
            {k: rel[k] for k in ("W1", "W2")})


def train_trainer(dims, params, optimizer, device, trainer=TraTrainer,
                  **engine_kw):
    """A ``trainer`` of the §5.3 step on a fresh
    ``Engine(executor="jit", validate="strict")`` (``engine_kw``: more of
    the engine's options, another executor among them)."""
    from repro_torch.core import Engine
    from repro_torch.core.programs import ffnn_train_step_tra
    engine_kw.setdefault("executor", "jit")
    return trainer(Engine(device=device, validate="strict", **engine_kw),
                   ffnn_train_step_tra(*dims, optimizer=optimizer),
                   params=params)


def diag_counts(engine) -> dict:
    """The engine's last verified compile's diagnostics, counted by pass
    and severity (``"memory/info": 1``); fails on an error."""
    diags = engine.last_diagnostics
    if diags is None:
        return {}
    if diags.errors:
        fail(f"verifier errors:\n{diags.render()}")
    return dict(collections.Counter(f"{d.pass_name}/{d.severity}"
                                    for d in diags))


def verify_ms(engine, roots, phase: str) -> list:
    """The verifier's host ms for the engine's one compile: 5
    ``verify_plans`` calls on the compiled plans with the logical
    ``roots``, as ``Engine._verify_compile`` makes them; fails on an
    error."""
    from repro_torch.analysis import verify_plans
    from repro_torch.core.plan import as_node
    (entry,) = engine.cache_info()
    logical = tuple(as_node(r) for r in roots.values())
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        diags = verify_plans(entry.compiled.roots, executor=entry.executor,
                             axis_sizes=engine.axis_sizes,
                             memory_budget=engine.memory_budget,
                             fuse=engine.fuse, logical_roots=logical)
        times.append((time.perf_counter() - t0) * 1e3)
    if diags.errors:
        fail(f"{phase}: the step plan's verifier errors\n{diags.render()}")
    return times


def verifier_readings(engine, roots, peak: int) -> dict:
    """The step plan's diagnostics by pass and severity, the verifier's
    host ms for the step's compile (the median of ``verify_ms``), and
    the memory pass's two peak models beside the card's
    ``max_memory_allocated`` and the tensor-core route's TF32 terms of
    X·W1, which neither model counts (``cost.plan_peak_bytes``)."""
    from repro_torch.analysis.memory import independent_peak_bytes
    from repro_torch.core.cost import plan_peak_bytes
    times = verify_ms(engine, roots, "train")
    (entry,) = engine.cache_info()
    plans = entry.compiled.roots
    model = plan_peak_bytes(plans, fuse=engine.fuse)
    independent = independent_peak_bytes(plans, fuse=engine.fuse)
    return {"diagnostics": diag_counts(engine),
            "verify_ms": times, "verify_ms_median": sorted(times)[2],
            "plan_peak_bytes": model,
            "independent_peak_bytes": independent,
            "max_memory_allocated": peak,
            "card_minus_model_bytes": peak - model}


def dense_f64_step(dense, z1, z1_plain) -> dict:
    """The loss and both gradients of the first step, dense and in f64 on
    the card, from the formulas of the dense oracle of
    ``tests/test_train.py``: a2 = σ(relu(X·W1)·W2), the clipped BCE sum,
    and its gradients through ∂L/∂z2 = a2 − Y.

    ``z1`` is X·W1 as the step's kernel computes it (through the route the
    engine takes, on the dense operands, which the engine's blocked views
    stand for; the route is deterministic and reads a view and a
    contiguous tensor alike): held against the f64 product within
    ``tolerance(D, f32)``.  relu' is taken from the sign of ``z1``, the
    mask the step used, so that the oracle's W1 gradient is the step's
    own function everywhere: where a z1 within rounding of 0 has the other
    sign than the f64 product, relu' would differ for the whole hidden
    unit's column of the gradient.

    ``z1_plain`` is X·W1 as the plain run computes it (``matmul_ref``).
    Where it and ``z1`` take different signs, that column of the plain
    run's W1 gradient differs from the kernel run's: ``flips`` marks those
    columns.  Each such sign must lie within the z1 gate's own limit of 0
    (|z1_f64| ≤ atol + rtol·|z1_f64|); any other fails the run.

    Readings of both z1 against f64, beside the kernel's gate (the plain
    one's share of the limit is not gated): the RMS error, the mean error
    along the sign of the f64 value (a drift toward zero reads negative)
    and the signs that differ from the f64 product's."""
    x, y = dense["X"].double(), dense["Y"].double()
    w1, w2 = dense["W1"].double(), dense["W2"].double()
    d = x.shape[1]
    rtol, atol = tolerance(d, torch.float32)
    a1 = x @ w1                                 # z1, then relu(z1) in place
    flips = torch.zeros(a1.shape[1], dtype=torch.bool, device=a1.device)
    step = 10_000
    n_flips, past_limit = 0, 0
    sums = {what: {"held": [], "sq": 0.0, "along": 0.0, "flips": 0}
            for what in ("kernel", "plain")}
    for c in range(0, a1.shape[1], step):
        cols = slice(c, c + step)
        exact = a1[:, cols]
        for what, z in (("kernel", z1), ("plain", z1_plain)):
            acc = sums[what]
            acc["held"].append(held(f"z1 = X·W1 ({what}) vs f64", z[:, cols],
                                    exact, d, gate=what == "kernel"))
            err = z[:, cols].double() - exact
            acc["sq"] += err.square().sum().item()
            acc["along"] += (err * exact.sign()).sum().item()
            acc["flips"] += int(((z[:, cols] > 0) != (exact > 0)).sum())
            del err
        flip = (z1[:, cols] > 0) != (z1_plain[:, cols] > 0)
        n_flips += int(flip.sum())
        past_limit += int((flip & (exact.abs() > atol + rtol * exact.abs()))
                          .sum())
        flips[cols] = flip.any(0)
        del flip
    readings = {}
    for what, acc in sums.items():
        readings[what] = {
            **max(acc["held"], key=lambda r: r["worst_share_of_limit"]),
            "rms_err": math.sqrt(acc["sq"] / a1.numel()),
            "mean_err_along_sign": acc["along"] / a1.numel(),
            "sign_flips_vs_f64": acc["flips"]}
    if past_limit:
        fail(f"train z1: {past_limit} of the {n_flips} signs where the "
             f"kernel and the plain run differ lie past the z1 limit of 0")
    a1.clamp_min_(0.0)
    a2 = torch.sigmoid(a1 @ w2)
    pc = a2.clamp(1e-7, 1.0 - 1e-7)
    loss = -(y * torch.log(pc) + (1.0 - y) * torch.log1p(-pc)).sum()
    dz2 = a2 - y
    g2 = a1.T @ dz2
    del a1
    dz1 = dz2 @ w2.T
    dz1.mul_(z1 > 0)                            # the step's own relu mask
    g1 = x.T @ dz1
    del dz1
    return {"loss": loss, "W1": g1, "W2": g2, "flips": flips,
            "z1_vs_f64": readings["kernel"],
            "z1_plain_vs_f64": readings["plain"],
            "sign_flips_vs_plain": n_flips, "flip_columns": int(flips.sum())}


def held(what: str, got, ref, k: int, where=None, gate=True,
         phase: str = "train") -> dict:
    """``got`` (f32) against ``ref`` within ``tolerance(k, f32)``, where
    ``where`` is true (everywhere by default); fails otherwise, naming
    ``phase``, unless ``gate`` is false (a reading only)."""
    rtol, atol = tolerance(k, torch.float32)
    got = torch.as_tensor(got).double()
    ref = torch.as_tensor(ref, device=got.device).double()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        fail(f"{phase} {what}: shape {tuple(got.shape)} against "
             f"{tuple(ref.shape)}, or not finite")
    err, lim = (got - ref).abs(), atol + rtol * ref.abs()
    if where is not None:
        err, lim = err[where], lim[where]
    over = int((err > lim).sum())
    out = {"max_abs_err": err.max().item() if err.numel() else 0.0,
           "worst_share_of_limit": (err / lim).max().item()
           if err.numel() else 0.0, "values_over": over, "rtol": rtol,
           "atol": atol, "k": k}
    if over and gate:
        fail(f"{phase} {what}: {over} values over rtol={rtol} atol={atol} "
             f"(max |err| {out['max_abs_err']})")
    return out


def adamw_first_update(w, g, lr):
    """AdamW's parameter after its first step from zero moments, in f64:
    m̂ = g, v̂ = g², p' = p − lr·m̂/(√v̂ + eps) (no weight decay)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    m, v = (1.0 - b1) * g, (1.0 - b2) * g * g
    return w - lr * (m / (1.0 - b1)) / (torch.sqrt(v / (1.0 - b2)) + eps)


def train_checks(first: dict, plain: dict, ref: dict, dense, cfg,
                 prefix: str, adam: bool) -> dict:
    """One step's outputs (the loss, W1' and W2', and AdamW's moments)
    against the plain-matmul run's and the f64 oracle's, each within
    ``tolerance(k, f32)`` of the product that computes it: the loss the
    second forward product's (K = H), the gradients' the batch (K = N).
    AdamW's W' is held where the reference |g| exceeds
    ``ADAM_GATE_ATOLS`` times the gradient's atol.  W1's first moment is
    held against the f64 oracle (relu' from the step's own z1) everywhere,
    and against the plain run outside the ``flips`` columns of
    :func:`dense_f64_step` (a reading inside them); the counts are
    reported."""
    k_loss, k_grad = cfg.d_hidden, cfg.batch
    _, atol = tolerance(k_grad, torch.float32)
    lr = CHECK_LR if adam else SGD_LR
    checks = {}
    for against, want in (("plain", plain["loss"]), ("f64", ref["loss"])):
        checks[f"{prefix}loss_vs_{against}"] = held(
            f"{prefix}loss vs {against}", first["loss"], want, k_loss)
    same_sign = ~ref["flips"][None, :].expand(cfg.d_in, -1)
    for name in ("W1", "W2"):
        g, w = ref[name], dense[name].double()
        if adam:
            gate = g.abs() > ADAM_GATE_ATOLS * atol
            checks[f"{name}_below_the_gate"] = int((~gate).sum())
            exact = {name: adamw_first_update(w, g, lr),
                     f"{name}.m": 0.1 * g, f"{name}.v": 0.001 * g * g}
        else:
            gate, exact = None, {name: w - lr * g}
        for key, value in exact.items():
            got, want = dense_of(first[key]), dense_of(plain[key])
            where = gate if key == name else \
                same_sign if key == "W1.m" else None
            checks[f"{prefix}{key}_vs_plain"] = held(
                f"{prefix}{key} vs plain", got, want, k_grad, where)
            checks[f"{prefix}{key}_vs_f64"] = held(
                f"{prefix}{key} vs f64", got, value, k_grad,
                gate if key == name else None)
            if key == "W1.m":
                checks[f"{prefix}W1.m_vs_plain_in_flip_columns"] = held(
                    "W1.m vs plain where z1's signs differ", got, want,
                    k_grad, ~same_sign, gate=False)
        del exact, w
    return checks


def first_step_checks(cfg, dims, dense, data, params, device) -> dict:
    """Step 1 at the check rates (AdamW, SGD) on the kernels, on the plain
    matmul and in f64, the first product's output z1 held on its own
    (:func:`dense_f64_step`, :func:`train_checks`): z1 through the route
    the engine takes (``matmul(X, W1, impl="kernel")``) and through the
    plain version."""
    from repro_torch.core import AdamW, SGD
    z1 = mm_ops.matmul(dense["X"], dense["W1"], impl="kernel")
    z1_plain = matmul_ref(dense["X"], dense["W1"])
    ref = dense_f64_step(dense, z1, z1_plain)
    del z1, z1_plain
    checks = {key: ref[key] for key in (
        "z1_vs_f64", "z1_plain_vs_f64", "sign_flips_vs_plain",
        "flip_columns")}
    for prefix, make in (("", lambda: AdamW(CHECK_LR)),
                         ("sgd_", lambda: SGD(SGD_LR))):
        run = train_trainer(dims, params, make(), device)
        got = step_outputs(run, run.step(**data))
        with plain_matmul():
            plain = train_trainer(dims, params, make(), device)
            want = step_outputs(plain, plain.step(**data))
        checks.update(train_checks(got, want, ref, dense, cfg, prefix,
                                   adam=not prefix))
        del run, got, plain, want
    return checks


def step_outputs(trainer, loss) -> dict:
    return {"loss": loss, **trainer.params, **trainer.state}


def dense_of(value):
    """A relation's dense tensor (its global value if the data is a
    DTensor); a tensor as it is."""
    from repro_torch.core import to_tensor
    return to_tensor(value) if hasattr(value, "rtype") else value


def narrow_plan(m: int, k: int, n: int, sms: int):
    """The narrow kernel's plan (``mm_ops.plan_narrow``) for contiguous 2-D
    operands of this shape."""
    op = mm_ops.plan_operands(((m, k), (k, 1), 0, 1),
                              ((k, n), (n, 1), 0, 1), "narrow")
    return mm_ops.plan_narrow(op.a, op.b, op.b_plan, sms)


def train_routes(products, sms: int) -> tuple:
    """Each train product ``(m, k, n)``'s route (``mm_ops.route``, f32 on
    the card) and the K splits it takes there (the tile kernel's
    ``plan_launch``, the narrow kernel's ``plan_narrow``; 1 elsewhere)."""
    routes = [mm_ops.route(torch.empty(m, k, device="meta"),
                           torch.empty(k, n, device="meta"), "kernel")
              for m, k, n in products]
    splits = [mm_ops.plan_launch(m, n, k, sms)[1] if r == "tile"
              else narrow_plan(m, k, n, sms).splits if r == "narrow" else 1
              for (m, k, n), r in zip(products, routes)]
    return routes, splits


def train_launches(routes, splits, steps: int) -> dict:
    """The launch counts ``steps`` train steps should read: per step and
    product, the tensor-core kernel and its two split passes, the narrow
    kernel (folding when split), or the tile kernel and its split-K pass
    (when split), by each product's route; no copy."""
    def count(route, split=None):
        return steps * sum(r == route and (split is None or (s > 1) == split)
                           for r, s in zip(routes, splits))
    return launches_of(matmul_tc=count("tc"),
                       matmul_tf32_split=2 * count("tc"),
                       matmul=count("tile"),
                       matmul_splitk_reduce=count("tile", True),
                       matmul_narrow=count("narrow"),
                       matmul_narrow_fold=count("narrow", True))


def train_products(calls, device) -> list:
    """The step's two matmul calls, each timed as the engine makes it (the
    relations' views, in place or with the op's copies) and on 2-D
    contiguous copies through the op's route (for X·W1 the tensor-core
    route: also its two split passes and ``matmul_tc_kernel`` alone; for
    a1·W2 the narrow kernel, one launch), the FFMA tile kernel with its
    split-K pass (the route both took before: kept as the earlier
    reading), the plain version and ``torch.matmul``, with the bounds (on
    the tensor-core route both: three TF32 products at the tensor cores'
    rate, one f32 product at the FFMA rate); the route's and the tile
    kernel's outputs held against the plain version within
    ``tolerance(k, f32)``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for (a, b, kw), name in zip(calls, ("first", "second")):
        m = math.prod(a.shape[:kw["a_rows"]])
        k = math.prod(a.shape[kw["a_rows"]:])
        n = math.prod(b.shape[kw["b_rows"]:])
        a2, b2 = a.reshape(m, k).contiguous(), b.reshape(k, n).contiguous()
        route = mm_ops.route(a2, b2, "kernel")
        ref = matmul_ref(a2, b2)
        rtol, atol = tolerance(k, torch.float32)
        errs = {}
        for what, fn in (("kernel", lambda: mm_ops.matmul(a2, b2,
                                                          impl="kernel")),
                         ("tile", lambda: tile_kernel(a2, b2))):
            out = fn()
            torch.cuda.synchronize(device)
            err = (out - ref).abs()
            if not bool(torch.isfinite(out).all()) or bool(
                    (err > atol + rtol * ref.abs()).any()):
                fail(f"train {name} product on the {what} route: max |err| "
                     f"{err.max().item()} over rtol={rtol} atol={atol}")
            errs[what] = err.max().item()
            del out, err
        del ref
        t_bytes, t_ops = bound_times(m, k, n, torch.float32, route)
        bnd, by = bound_of(t_bytes, t_ops)
        iters = 3 if k * n > 10 ** 8 else 10
        timed = {"kernel": lambda: mm_ops.matmul(a2, b2, impl="kernel"),
                 "in_place": lambda: mm_ops.matmul(a, b, **kw),
                 "tile": lambda: tile_kernel(a2, b2),
                 "plain": lambda: matmul_ref(a2, b2),
                 "library": lambda: torch.matmul(a2, b2)}
        row = {"product": name, "m": m, "k": k, "n": n, "route": route,
               "a_contiguous": a.is_contiguous(),
               "b_contiguous": b.is_contiguous(),
               "tile_splits": mm_ops.plan_launch(m, n, k, sms)[1],
               **{f"{what}_ms": timed_ms(fn, device, iters, warmup=1)
                  for what, fn in timed.items()},
               "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
               "operations_ms": t_ops,
               "ffma_operations_ms": bound_times(m, k, n,
                                                 torch.float32)[1],
               "max_abs_err": errs["kernel"], "tile_max_abs_err": errs["tile"],
               "rtol": rtol, "atol": atol}
        if route == "narrow":
            nw = narrow_plan(m, k, n, sms)
            row.update({"narrow_splits": nw.splits,
                        "narrow_stages": nw.stages})
        if route == "tc":
            kp = mm_ops.tc_kp(k)
            sa = mm_ops.tf32_split(a2)
            sb = mm_ops.tf32_split(b2, transpose=True)
            s_bytes, s_ops = split_bound_times(m, k, n)
            row.update({
                "split_passes_ms": timed_ms(lambda: (
                    mm_ops.tf32_split(a2),
                    mm_ops.tf32_split(b2, transpose=True)),
                    device, iters, warmup=1),
                "split_plain_ms": timed_ms(lambda: (
                    tf32_split_ref(a2, kp), tf32_split_ref(b2, kp, True)),
                    device, iters, warmup=1),
                "split_max_abs_err": max(
                    (sa - tf32_split_ref(a2, kp)).abs().max().item(),
                    (sb - tf32_split_ref(b2, kp, True)).abs().max().item()),
                "split_bytes_ms": s_bytes, "split_operations_ms": s_ops,
                "tc_kernel_ms": timed_ms(lambda: mm_ops._tc_gemm(
                    sa, sb, m, n, torch.float32), device, iters, warmup=1)})
            if row["split_max_abs_err"] != 0.0:
                fail(f"train {name} product: the split passes differ from "
                     f"tf32_split_ref by {row['split_max_abs_err']}")
            del sa, sb
        rows.append(row)
        del a2, b2
    return rows


def phase_train(device) -> dict:
    """The §5.3 FFNN trains at speech-100k through the port's Engine,
    plan-level autodiff and ``TraTrainer`` (AdamW at ``TRAIN_LR``), X·W1 on
    the tensor-core route (two split passes, ``matmul_tc_kernel``), a1·W2
    on the narrow kernel (its split-K sum folded in the launch); step 1 at
    the check rates against the plain matmul and the f64 oracle."""
    from repro_torch.core import AdamW
    t0 = time.perf_counter()
    cfg, dims, dense = train_problem(device)
    data, params = train_relations(dims, dense)
    trainer = train_trainer(dims, params, AdamW(TRAIN_LR), device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n, d, h, l_ = cfg.batch, cfg.d_in, cfg.d_hidden, cfg.d_out
    products = [(n, d, h), (n, h, l_)]
    routes, splits = train_routes(products, sms)
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    step_ms, copies = [], []
    for _ in range(TRAIN_STEPS):
        c0 = mm_ops.COPIES
        torch.cuda.synchronize(device)
        s0 = time.perf_counter()
        trainer.step(**data)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - s0) * 1e3)
        copies.append(mm_ops.COPIES - c0)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    eng = trainer.engine
    if eng.cache_misses != 1 or eng.cache_hits != TRAIN_STEPS - 1:
        fail(f"train: {eng.cache_misses} compiles and {eng.cache_hits} "
             f"cached dispatches in {TRAIN_STEPS} steps, expected 1 and "
             f"{TRAIN_STEPS - 1}")
    losses = list(trainer.history)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"train: losses {losses} not finite or not decreasing")
    # X and W1 read in place by the split passes, a1 and W2 by the narrow
    # kernel: no operand is copied
    expected = train_launches(routes, splits, TRAIN_STEPS)
    if launches != expected:
        fail(f"train: launches {launches} in {TRAIN_STEPS} steps, "
             f"expected {expected}")
    verifier = verifier_readings(eng, trainer.program.roots, peak)
    verifier["tf32_terms_bytes"] = 2 * (n + h) * mm_ops.tc_kp(d) * 4

    checks = first_step_checks(cfg, dims, dense, data, params, device)

    # one more step, profiled by kernel, with the matmul calls it makes
    calls, real = [], mm_ops.matmul

    def spy(a, b, **kw):
        calls.append((a, b, kw))
        return real(a, b, **kw)

    mm_ops.matmul = spy
    try:
        profile = device_profile(lambda: trainer.step(**data),
                                 TRAIN_GROUPS)
    finally:
        mm_ops.matmul = real
    if len(calls) != len(products):
        fail(f"train: {len(calls)} matmul calls in a step, expected "
             f"{len(products)}")
    rows = train_products(calls, device)
    del calls
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    reduce = reduce_case(n, h, l_, device, gen, iters=20)
    med = sorted(step_ms[1:])
    out = {"phase": "train", "path": TRAIN_PATH,
           "width": [d, h, l_], "batch": n, "dims": list(dims),
           "optimizer": f"AdamW({TRAIN_LR})",
           "check_optimizers": [f"AdamW({CHECK_LR})", f"SGD({SGD_LR})"],
           "steps": TRAIN_STEPS,
           "losses": losses, "step_ms": step_ms,
           "step_ms_median_2_to_5": (med[len(med) // 2]
                                     + med[(len(med) - 1) // 2]) / 2,
           "cache": {"misses": eng.cache_misses, "hits": eng.cache_hits},
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items() if v},
           "matmul_copies_per_step": copies,
           "routes": routes, "splits": splits,
           "max_memory_allocated_gb": peak / 1e9, "checks": checks,
           "verifier": verifier,
           "profile_step": profile, "products": rows,
           "splitk_reduce": reduce, "setup_s": setup_s,
           "phase_s": time.perf_counter() - t0}
    emit(out)
    del trainer, data, params, dense
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- checkpoint store
CKPT_PATH = "ffnn-ckpt-speech-100k"
CKPT_STEPS = 8                   # the uninterrupted run and the resumed one
CKPT_FAILED_RUN = 5              # the failing dispatch, counted from 0
CKPT_KILLED_AT = 6               # the recovering run's fit(...)
CKPT_EVERY = 2
CKPT_KEEP = 2


class TimedTrainer(TraTrainer):
    """The trainer with each restore's ms from disk to the card (as
    ``fit`` calls it), ending in a synchronize, in ``restores``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.restores = []

    def restore_checkpoint(self, store=None, step=None) -> int:
        t0 = time.perf_counter()
        out = super().restore_checkpoint(store, step)
        torch.cuda.synchronize(self.engine.device)
        self.restores.append({"step": out,
                              "ms": (time.perf_counter() - t0) * 1e3})
        return out


def host_state(trainer) -> dict:
    """The trainer's parameters and optimizer state copied to the host."""
    return {k: r.data.cpu() for k, r in
            {**trainer.params, **trainer.state}.items()}


def uninterrupted(dims, params, data, device) -> dict:
    """``CKPT_STEPS`` steps on a fresh trainer, each timed: the losses,
    the host copies of the parameters and AdamW moments after step
    ``CKPT_KILLED_AT`` and after the last, the launches."""
    from repro_torch.core import AdamW
    tr = train_trainer(dims, params, AdamW(TRAIN_LR), device)
    step_ms, at_kill = [], None
    reset_launches()
    for i in range(CKPT_STEPS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        tr.step(**data)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == CKPT_KILLED_AT:
            at_kill = host_state(tr)
    out = {"launches": read_launches(), "losses": list(tr.history),
           "step_ms": step_ms, "at_kill": at_kill, "final": host_state(tr)}
    del tr
    torch.cuda.empty_cache()
    return out


def differing(got: dict, want: dict) -> list:
    """The names of the tensors of ``got`` not bit-equal to ``want``'s."""
    return [k for k in want if not torch.equal(got[k], want[k])]


def phase_ckpt(device) -> dict:
    """The §5.3 FFNN trained at speech-100k through ``TraTrainer`` with a
    ``CheckpointStore`` (``tests/test_robustness.py:93-112`` at full
    width): an uninterrupted 8-step run; a run on a store keeping 2 steps,
    checkpointed every 2 steps, with a site failure injected at its
    dispatch 5 (``FaultInjector`` counts runs from 0: the 6th, step 6),
    recovered from the last committed step (4) and ending at step 6; a
    fresh trainer on a fresh ``Engine(validate="strict")`` resuming to
    step 8.  The recovered and resumed runs' losses, parameters and
    AdamW moments equal the uninterrupted run's bit for bit."""
    from repro_torch.core import AdamW, FaultInjector
    t0 = time.perf_counter()
    warm = cublas_warm(device)
    torch.cuda.synchronize(device)
    allocated = phase_allocated(device)
    cfg, dims, dense = train_problem(device)
    data, params = train_relations(dims, dense)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n, d, h, l_ = cfg.batch, cfg.d_in, cfg.d_hidden, cfg.d_out
    routes, splits = train_routes([(n, d, h), (n, h, l_)], sms)

    # -- 1. the uninterrupted run ---------------------------------------
    run1 = uninterrupted(dims, params, data, device)
    snapshot_bytes = sum(t.numel() * t.element_size()
                         for t in run1["final"].values())

    base = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # -- 2. killed at its 5th dispatch, recovered, ends at step 6 ----
        store = CheckpointStore(base, keep=CKPT_KEEP)
        inj = FaultInjector().inject_site_failure(step=CKPT_FAILED_RUN)
        tr = train_trainer(dims, params, AdamW(TRAIN_LR), device,
                           trainer=TimedTrainer, fault_injector=inj)
        reset_launches()
        torch.cuda.synchronize(device)
        r0 = time.perf_counter()
        tr.fit(CKPT_KILLED_AT, store=store, ckpt_every=CKPT_EVERY, **data)
        torch.cuda.synchronize(device)
        run2_s = time.perf_counter() - r0
        run2 = {"launches": read_launches(), "losses": list(tr.history),
                "state": host_state(tr), "log": list(inj.log),
                "steps": tr.step_count, "restores": tr.restores,
                "committed": store.committed_steps(),
                "cache": {"misses": tr.engine.cache_misses,
                          "hits": tr.engine.cache_hits},
                "diagnostics": diag_counts(tr.engine)}
        del tr
        torch.cuda.empty_cache()

        # -- 3. a fresh trainer on a fresh strict engine resumes to 8 ----
        tr = train_trainer(dims, params, AdamW(TRAIN_LR), device,
                           trainer=TimedTrainer)
        reset_launches()
        r0 = time.perf_counter()
        tr.fit(CKPT_STEPS, store=store, resume=True, **data)
        torch.cuda.synchronize(device)
        run3_s = time.perf_counter() - r0
        run3 = {"launches": read_launches(), "losses": list(tr.history),
                "final": host_state(tr), "steps": tr.step_count,
                "restores": tr.restores}
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)

    if run2["log"] != [("site", f"run {CKPT_FAILED_RUN}")]:
        fail(f"ckpt: the injector fired {run2['log']}, expected the one "
             f"site failure at run {CKPT_FAILED_RUN}")
    if run2["steps"] != CKPT_KILLED_AT or run3["steps"] != CKPT_STEPS:
        fail(f"ckpt: the runs ended at steps {run2['steps']} and "
             f"{run3['steps']}")
    # the last step committed before the failure: every CKPT_EVERY steps
    restored = CKPT_FAILED_RUN // CKPT_EVERY * CKPT_EVERY
    restores, resumes = run2["restores"], run3["restores"]
    if [r["step"] for r in restores] != [restored] or \
            [r["step"] for r in resumes] != [CKPT_KILLED_AT]:
        fail(f"ckpt: restored steps {restores} and {resumes}")
    # the failed dispatch raises in CompiledExpr.run before its schedule
    # runs: it launches nothing, so each run's launches are its dispatched
    # steps' (run 2: 5 before the failure, then steps 5 and 6 again from
    # the restored step 4)
    for what, got, steps in (("uninterrupted", run1, CKPT_STEPS),
                             ("recovered", run2, CKPT_FAILED_RUN
                              + CKPT_KILLED_AT - restored),
                             ("resumed", run3,
                              CKPT_STEPS - CKPT_KILLED_AT)):
        want = train_launches(routes, splits, steps)
        if got["launches"] != want:
            fail(f"ckpt {what}: launches {got['launches']}, expected "
                 f"{want} ({steps} steps)")
    bitwise = {
        "recovered_losses": run2["losses"] == run1["losses"][:CKPT_KILLED_AT],
        "recovered_state": differing(run2["state"], run1["at_kill"]),
        "resumed_losses": run3["losses"] == run1["losses"],
        "resumed_state": differing(run3["final"], run1["final"])}
    if not (bitwise["recovered_losses"] and bitwise["resumed_losses"]) or \
            bitwise["recovered_state"] or bitwise["resumed_state"]:
        again = uninterrupted(dims, params, data, device)
        agree = again["losses"] == run1["losses"] and not differing(
            again["final"], run1["final"])
        emit({"phase": "ckpt", "bitwise": bitwise,
              "losses": {"uninterrupted": run1["losses"],
                         "recovered": run2["losses"],
                         "resumed": run3["losses"],
                         "second_uninterrupted": again["losses"]},
              "uninterrupted_runs_agree": agree})
        fail("ckpt: the recovered or resumed run differs from the "
             "uninterrupted one; " + (
                 "two uninterrupted runs agree, so the store or the restore "
                 "is at fault" if agree else
                 "two uninterrupted runs differ too: a kernel of the step "
                 "is not deterministic"))
    med = sorted(run1["step_ms"][1:])
    step_ms = (med[len(med) // 2] + med[(len(med) - 1) // 2]) / 2
    launches = {k: run1["launches"][k] + run2["launches"][k]
                + run3["launches"][k] for k in run1["launches"]}
    out = {"phase": "ckpt", "path": CKPT_PATH,
           "width": [d, h, l_], "batch": n, "dims": list(dims),
           "optimizer": f"AdamW({TRAIN_LR})", "keep": CKPT_KEEP,
           "ckpt_every": CKPT_EVERY, "failed_run": CKPT_FAILED_RUN,
           "losses": run1["losses"], "bitwise": bitwise,
           "launches": launches,
           "launches_by_run": {"uninterrupted": run1["launches"],
                               "recovered": run2["launches"],
                               "resumed": run3["launches"]},
           "recovered": {k: run2[k] for k in ("committed", "cache",
                                              "diagnostics", "log")},
           "snapshot_bytes": snapshot_bytes,
           "snapshot_d2h_ms": [s * 1e3 for s in store.stats.snapshot_s],
           "snapshot_gb_s": [snapshot_bytes / s / 1e9
                             for s in store.stats.snapshot_s],
           "writer_s": store.stats.write_s,
           "stall_ms": [s * 1e3 for s in store.stats.stall_s],
           "restore_ms": restores + resumes,
           "step_ms": run1["step_ms"], "step_ms_median_2_to_8": step_ms,
           "recovered_run_s": run2_s,
           "recovered_dispatched_steps": CKPT_FAILED_RUN + CKPT_KILLED_AT
           - restored,
           "recovered_run_over_6_steps": run2_s * 1e3 / (
               CKPT_KILLED_AT * step_ms),
           "resumed_run_s": run3_s,
           "phase_s": time.perf_counter() - t0,
           "cublas_warm_bytes": warm}
    del run1, run2, run3, data, params, dense
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    out["allocated_after_bytes"] = phase_allocated(device) - allocated
    emit(out)
    if out["allocated_after_bytes"] > 0:
        fail(f"ckpt: {out['allocated_after_bytes']} bytes still allocated "
             f"on the card after the phase")
    return out


# ------------------------------------------------------- mesh executors
MESH_PATH = "ffnn-train-mesh-speech-100k"
MESH_STEPS = 3
MESH_EXECUTORS = ("shard_map", "gspmd")
MESH_AXES = ("sites",)
MESH_WORLD = 2                  # two ranks sharing the card, over gloo
MESH_TIMEOUT = 420.0            # the two-rank run's deadline (s), and its
#                                 group's collective timeout
MESH_LOSS_RTOL = 1e-5           # mesh2's losses against mesh1's


def mesh_places() -> dict:
    """``tests/_distributed_checks.py:229``'s plan: X and Y partitioned on
    key dim 0 over the sites, W1 and W2 replicated."""
    from repro_torch.core import Placement
    part = Placement.partitioned((0,), MESH_AXES)
    rep = Placement.replicated()
    return {"X": part, "Y": part, "W1": rep, "W2": rep}


def mesh_products(compiled, axis_sizes) -> list:
    """``(m, k, n)`` of each product a rank's dispatch hands the matmul op:
    every ``FusedJoinAgg`` of ``matMul`` and ``matAdd`` among the
    executor's steps (structurally identical nodes once, as the executor
    runs them), at the operands' local key windows (a partitioned key dim
    divided by its axis; a joined dim at the sharded side's window)."""
    from repro_torch.core.engine import schedule_steps
    from repro_torch.core.plan import infer

    def local(info) -> list:
        ks, p = list(info.rtype.key_shape), info.placement
        if p is not None and p.kind == "partitioned":
            for d, ax in zip(p.dims, p.axes):
                ks[d] //= axis_sizes[ax]
        return ks

    out = []
    steps, _, _ = schedule_steps(compiled.roots, fuse=False)
    for n, _, _ in steps:
        if not (isinstance(n, FusedJoinAgg) and n.join_kernel.name == "matMul"
                and n.agg_kernel.name == "matAdd"):
            continue
        lt, rt = infer(n.left), infer(n.right)
        lk, rk = local(lt), local(rt)
        kept_l = [f for d, f in enumerate(lk) if d not in n.join_keys_l]
        kept_r = [f for d, f in enumerate(rk) if d not in n.join_keys_r]
        joined = [min(lk[a], rk[b]) for a, b in zip(n.join_keys_l,
                                                    n.join_keys_r)]
        out.append((math.prod(kept_l) * lt.rtype.bound[0],
                    math.prod(joined) * lt.rtype.bound[1],
                    math.prod(kept_r) * rt.rtype.bound[1]))
    return out


MESH_STATE = ("W1", "W2", "W1.m", "W1.v", "W2.m", "W2.v")


def mesh_state(trainer, dense: bool = True) -> dict:
    """The trainer's parameters and AdamW moments: dense global tensors,
    or (``dense=False``) the relations as they are (DTensor data on a
    mesh engine)."""
    rels = {**trainer.params, **trainer.state}
    return {k: dense_of(rels[k]) if dense else rels[k] for k in MESH_STATE}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_train(mesh, executor, dims, data, params, device, sms) -> dict:
    """The §5.3 step on ``Engine(mesh, executor=...)``: step 1 at the
    check rate (its loss, parameters and moments, for ``train_checks``),
    then ``MESH_STEPS`` steps at ``TRAIN_LR`` on a fresh strict engine with
    every launch count and ``shardmap_exec.COLLECTIVES`` 0 just before and
    read just after: host ms a step (synchronized), each step's
    collectives (bytes by kind, re-placed inputs, staged bytes, exchange
    ms), the schedule against ``expected_schedule``, the launches against
    the plan's products' routes, the peak, the optimizer's cost."""
    from repro_torch.core import AdamW
    from repro_torch.core.shardmap_exec import COLLECTIVES, expected_schedule
    kw = {"mesh": mesh, "executor": executor,
          "input_placements": mesh_places()}
    check = train_trainer(dims, params, AdamW(CHECK_LR), device, **kw)
    first = {"loss": check.step(**data), **mesh_state(check, dense=False)}
    del check
    trainer = train_trainer(dims, params, AdamW(TRAIN_LR), device, **kw)
    eng = trainer.engine
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    COLLECTIVES.clear()
    steps = []
    for _ in range(MESH_STEPS):
        sync(device)
        t0 = time.perf_counter()
        trainer.step(**data)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        (entry,) = eng.cache_info()
        ex = entry.compiled.exchange
        steps.append({"ms": ms, "bytes_by_kind": ex.bytes_by_kind(),
                      "reshard_bytes": ex.reshard_bytes,
                      "staged_bytes": ex.staged_bytes,
                      "exchange_ms": ex.ms(),
                      "collectives": len(ex.log),
                      "schedule": [o.describe() for o in ex.schedule()]})
    launches = read_launches()
    collectives = dict(COLLECTIVES)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    compiled = entry.compiled
    want = [o.describe() for o in expected_schedule(compiled.roots,
                                                    eng.axis_sizes)]
    products = mesh_products(compiled, eng.axis_sizes)
    expected = train_launches(*train_routes(products, sms), MESH_STEPS)
    ms = sorted(s["ms"] for s in steps[1:])
    out = {"executor": executor, "first": first,
           "losses": list(trainer.history),
           "state": mesh_state(trainer, dense=False),
           "steps": steps, "step_ms_median_2_to_3": ms[len(ms) // 2]
           if len(ms) % 2 else (ms[0] + ms[-1]) / 2,
           "launches": launches, "expected_launches": expected,
           "products": products, "collectives_by_kind": collectives,
           "schedule_ok": executor == "gspmd" or all(
               st["schedule"] == want for st in steps),
           "expected_schedule": want,
           "cache": {"misses": eng.cache_misses, "hits": eng.cache_hits},
           "max_memory_allocated_gb": None if peak is None else peak / 1e9,
           "cost": compiled.cost}
    del trainer
    return out


def mesh_reference(cfg, dims, dense, data, params, device) -> tuple:
    """Step 1's references, computed once for both mesh runs: the dense
    f64 step (relu' from the kernel's z1) and the step on the plain
    matmul, both at AdamW(``CHECK_LR``) (:func:`first_step_checks`)."""
    from repro_torch.core import AdamW
    z1 = mm_ops.matmul(dense["X"], dense["W1"], impl="kernel") \
        if device.type == "cuda" else matmul_ref(dense["X"], dense["W1"])
    z1_plain = matmul_ref(dense["X"], dense["W1"])
    ref = dense_f64_step(dense, z1, z1_plain)
    del z1, z1_plain
    with plain_matmul():
        tr = train_trainer(dims, params, AdamW(CHECK_LR), device)
        plain = {"loss": tr.step(**data), **mesh_state(tr)}
    return ref, plain


def mesh_checks(runs, ref, plain, dense, cfg, prefix) -> dict:
    """Each executor's step 1 against the plain run and f64
    (:func:`train_checks`, AdamW)."""
    return {ex: train_checks(r["first"], plain, ref, dense, cfg,
                             f"{prefix}{ex}_", adam=True)
            for ex, r in runs.items()}


def mesh_gates(what: str, run: dict) -> None:
    if run["launches"] != run["expected_launches"]:
        fail(f"mesh {what} {run['executor']}: launches {run['launches']}, "
             f"expected {run['expected_launches']}")
    if not run["schedule_ok"]:
        fail(f"mesh {what} {run['executor']}: executed collectives "
             f"{[s['schedule'] for s in run['steps']]} against the "
             f"lowering's {run['expected_schedule']}")
    if run["cache"] != {"misses": 1, "hits": MESH_STEPS - 1}:
        fail(f"mesh {what} {run['executor']}: cache {run['cache']}")
    if not all(math.isfinite(x) for x in run["losses"]):
        fail(f"mesh {what} {run['executor']}: losses {run['losses']}")


def local_block(rel, path: str) -> tuple:
    """A relation's block on this rank, saved to ``path`` (``.npy``; a
    gigabyte crosses a file far faster than the ranks' result queue), with
    the tensor dim its mesh shards (``None``: replicated) and its type's
    shapes."""
    from repro_torch.core.shardmap_exec import placement_of
    data, dim = rel.data, None
    if hasattr(data, "device_mesh"):
        p = placement_of(data)
        dim = p.dims[0] if p.dims else None
        data = data.to_local()
    np.save(path, data.cpu().numpy())
    return (path, dim, tuple(rel.rtype.key_shape), tuple(rel.rtype.bound))


def joined_blocks(blocks, device):
    """The dense global tensor of one relation from every rank's
    :func:`local_block` (a 1-D mesh: blocks laid in rank order)."""
    from repro_torch.core import RelType, TensorRelation, to_tensor
    arrays = [np.load(b[0]) for b in blocks]
    _, dim, key_shape, bound = blocks[0]
    data = arrays[0] if dim is None else np.concatenate(arrays, axis=dim)
    return to_tensor(TensorRelation(torch.from_numpy(data).to(device),
                                    RelType(key_shape, bound)))


def mesh_rank(rank: int, world: int, out_dir: str) -> dict:
    """One rank of the two-rank run (gloo, the ranks sharing the card):
    the same problem drawn on the card from the seed, both executors on a
    ``("sites",)`` mesh of ``world`` ranks.  Each rank saves its blocks
    of step 1's parameters and moments under ``out_dir``
    (:func:`local_block`; the parent lays them together for its checks)
    and returns its own readings."""
    from repro_torch.launch.mesh import make_mesh
    entered = time.time()
    t0 = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, dims, dense = train_problem(device)
    data, params = train_relations(dims, dense)
    del dense
    mesh = make_mesh((world,), MESH_AXES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {"setup_s": time.perf_counter() - t0, "entered": entered}
    for ex in MESH_EXECUTORS:
        t1 = time.perf_counter()
        run = mesh_train(mesh, ex, dims, data, params, device, sms)
        first = run.pop("first")
        del run["state"]
        run["first"] = {k: v if k == "loss" else local_block(
            v, os.path.join(out_dir, f"{ex}.{k}.rank{rank}.npy"))
            for k, v in first.items()}
        del first
        torch.cuda.empty_cache()
        run["run_s"] = time.perf_counter() - t1
        out[ex] = run
    out["left"] = time.time()
    return out


def mesh1(dims, data, params, device, sms) -> dict:
    """World size 1 over NCCL in this process: both executors, then the
    ``jit`` engine's same steps (same placements) for the bit-for-bit
    comparison."""
    import torch.distributed as dist

    from repro_torch.core import AdamW
    from repro_torch.launch.mesh import init_sites, make_mesh
    with tempfile.TemporaryDirectory(prefix="mesh1-") as tmp:
        init_sites("nccl", store=dist.FileStore(os.path.join(tmp, "store"),
                                                1),
                   rank=0, world_size=1, device=device,
                   timeout=MESH_TIMEOUT)
        try:
            mesh = make_mesh((1,), MESH_AXES)
            runs = {ex: mesh_train(mesh, ex, dims, data, params, device,
                                   sms) for ex in MESH_EXECUTORS}
            for run in runs.values():       # read while the group lives
                for key in ("first", "state"):
                    run[key] = {k: dense_of(v) for k, v in run[key].items()}
        finally:
            dist.destroy_process_group()
    jit = train_trainer(dims, params, AdamW(TRAIN_LR), device,
                        input_placements=mesh_places())
    for _ in range(MESH_STEPS):
        jit.step(**data)
    jit_state, jit_losses = mesh_state(jit), list(jit.history)
    del jit
    for run in runs.values():
        state = run.pop("state")
        run["bit_equal_to_jit"] = {
            "losses": run["losses"] == jit_losses,
            **{k: bool(torch.equal(state[k], jit_state[k]))
               for k in MESH_STATE}}
        run["max_abs_diff_to_jit"] = {
            k: (state[k] - jit_state[k]).abs().max().item()
            for k in MESH_STATE}
        del state
    return runs


def mesh_reading(run: dict) -> dict:
    """A run's readings for the phase's line (tensors left out)."""
    return {k: v for k, v in run.items() if k not in ("first", "state")}


def phase_mesh(device, smi: str) -> dict:
    """The §5.3 FFNN trains at speech-100k through ``Engine(mesh,
    executor="shard_map" | "gspmd")`` on ``torch.distributed``: at world
    size 1 over NCCL in this process (``mesh1``), and at world size 2 with
    two processes sharing the card over gloo (``mesh2``), X and Y
    partitioned by rows, W1 and W2 replicated.  Step 1 of each executor
    at each size against the f64 step and the plain run (computed once);
    mesh1 beside the ``jit`` engine bit for bit; mesh2's losses within
    ``MESH_LOSS_RTOL`` of mesh1's; on shard_map every rank's executed
    collectives equal the lowering's; each rank's launches equal its
    products' routes.  Not a scaling figure: two ranks share one card."""
    from repro_torch.launch.mesh import run_sites
    t0 = time.perf_counter()
    warm = cublas_warm(device)
    allocated = phase_allocated(device)
    cfg, dims, dense = train_problem(device)
    data, params = train_relations(dims, dense)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ref, plain = mesh_reference(cfg, dims, dense, data, params, device)
    one = mesh1(dims, data, params, device, sms)
    del data, params
    torch.cuda.empty_cache()
    checks = {"mesh1": mesh_checks(one, ref, plain, dense, cfg, "mesh1_")}
    for ex, run in one.items():
        mesh_gates("mesh1", run)
        if not all(run["bit_equal_to_jit"].values()):
            fail(f"mesh1 {ex}: not bit-equal to the jit engine's steps "
                 f"({run['bit_equal_to_jit']}; largest differences "
                 f"{run['max_abs_diff_to_jit']})")

    t1 = time.perf_counter()
    blocks_dir = tempfile.TemporaryDirectory(prefix="mesh2-")
    t2, spawned = time.perf_counter(), time.time()
    ranks = run_sites(mesh_rank, MESH_WORLD, backend="gloo", device=device,
                      timeout=MESH_TIMEOUT, args=(blocks_dir.name,))
    mesh2_s, returned = time.perf_counter() - t2, time.time()
    firsts = {}
    for ex in MESH_EXECUTORS:
        runs = [r[ex] for r in ranks]
        for rank, run in enumerate(runs):
            mesh_gates(f"mesh2 rank {rank}", run)
            rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                       one[ex]["losses"])]
            run["loss_rel_diff_to_mesh1"] = rel
            if max(rel) > MESH_LOSS_RTOL or \
                    run["first"]["loss"] != runs[0]["first"]["loss"]:
                fail(f"mesh2 {ex} rank {rank}: losses {run['losses']} "
                     f"against mesh1's {one[ex]['losses']}, or step 1's "
                     f"loss unlike rank 0's")
        firsts[ex] = {"first": {k: runs[0]["first"]["loss"] if k == "loss"
                                else joined_blocks([r["first"][k]
                                                    for r in runs], device)
                                for k in runs[0]["first"]}}
        for run in runs:
            del run["first"]
    blocks_dir.cleanup()
    checks["mesh2"] = mesh_checks(firsts, ref, plain, dense, cfg, "mesh2_")
    mesh2_checks_s = time.perf_counter() - t2 - mesh2_s
    del firsts
    two = {ex: [r[ex] for r in ranks] for ex in MESH_EXECUTORS}
    out = {"phase": "mesh", "path": MESH_PATH, "nvidia_smi": smi,
           "dims": list(dims), "steps": MESH_STEPS,
           "placements": {k: p.describe() for k, p in mesh_places().items()},
           "mesh1": {ex: mesh_reading(r) for ex, r in one.items()},
           "mesh2": {ex: [mesh_reading(r) for r in runs]
                     for ex, runs in two.items()},
           "mesh1_s": t1 - t0, "mesh2_run_s": mesh2_s,
           "mesh2_rank_start_s": [r["entered"] - spawned for r in ranks],
           "mesh2_rank_setup_s": [r["setup_s"] for r in ranks],
           "mesh2_results_s": [returned - r["left"] for r in ranks],
           "mesh2_checks_s": mesh2_checks_s,
           "checks": checks,
           "scaling": "none: the two ranks of mesh2 share one card",
           "phase_s": time.perf_counter() - t0,
           "cublas_warm_bytes": warm}
    del ref, plain, dense, one, two, ranks
    sync(device)
    torch.cuda.empty_cache()
    out["allocated_after_bytes"] = phase_allocated(device) - allocated
    emit(out)
    if out["allocated_after_bytes"] > 0:
        fail(f"mesh: {out['allocated_after_bytes']} bytes still allocated "
             f"on the card after the phase")
    return out


def phase_lint() -> dict:
    """``python -m repro_torch.analysis.lint`` (on the card, its default):
    every verifier pass over the program corpus and the strict engine
    compile of the §5.3 train step; exit 0 required."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.splitlines()
    out = {"phase": "lint", "rc": proc.returncode,
           "s": time.perf_counter() - t0,
           "programs": [ln.strip() for ln in lines
                        if ln.startswith("  ") and not
                        ln.startswith("    ")],
           "summary": lines[-1] if lines else ""}
    emit(out)
    if proc.returncode != 0:
        fail(f"lint: exit {proc.returncode}\n{proc.stdout[-2000:]}"
             f"\n{proc.stderr[-2000:]}")
    return out


# ------------------------------------------------------------ out of core
OOC_PATH = "ffnn-oocore-speech-100k"
OOC_BUDGET = 2 ** 30             # stream-reduce: W1 and W2 from the host
OOC_OUT_BUDGET = 4 * 2 ** 30     # stream-out: X from the host
OOC_CAP = 4 * 2 ** 30            # rung 1: the process capped at this
OOC_RUNS = 5                     # synchronized runs timed (median)
OOC_LADDER_OK_CHUNK = 8          # rung 2: the injected OOM's ok_chunk
#: the store's split dims: W1 by its hidden blocks (key dim 1), W2 and X
#: by their leading key dim
OOC_SPLIT = {"X": 0, "W1": 1, "W2": 0}


def pinned_h2d_rate(device, nbytes: int = 64 * 2 ** 20) -> dict:
    """The card's host→device rate from a page-locked and from a pageable
    ``nbytes`` tensor (CUDA events over 20 copies each)."""
    out = {}
    dev = torch.empty(nbytes // 4, device=device)
    for what, pin in (("pinned", True), ("pageable", False)):
        host = torch.ones(nbytes // 4, pin_memory=pin)
        ms = timed_ms(lambda: dev.copy_(host, non_blocking=pin), device, 20)
        out[f"{what}_gb_s"] = nbytes / ms / 1e6
    out["bytes"] = nbytes
    return out


def z2_f64(dense) -> torch.Tensor:
    """z2 = relu(X·W1)·W2 dense in f64 on the card, by 10000 hidden
    columns at a time (a1 in f64 is 8 GB whole)."""
    x, w1, w2 = (dense[k].double() for k in ("X", "W1", "W2"))
    z2 = torch.zeros(x.shape[0], w2.shape[1], dtype=torch.float64,
                     device=x.device)
    for c in range(0, w1.shape[1], 10_000):
        z2 += torch.relu(x @ w1[:, c:c + 10_000]) @ w2[c:c + 10_000]
    return z2


def z2_relation(dims, dense2) -> torch.Tensor:
    """A dense (N, L) result in the relation layout of z2 (nb, lb, bn,
    bl)."""
    nb, _, _, lb, bn, _, _, bl = dims
    return dense2.reshape(nb, bn, lb, bl).permute(0, 2, 1, 3)


def timed_runs(fn, device, runs: int = OOC_RUNS) -> list:
    out = []
    for _ in range(runs):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def plan_products(compiled) -> list:
    """``(m, k, n)`` of each product of a compiled plan that reaches the
    matmul op: every ``FusedJoinAgg`` of ``matMul`` and ``matAdd`` (rows:
    the left's kept key blocks × its block rows; inner: the joined key
    blocks × the block columns; columns: the right's kept key blocks × its
    block columns).  A join the optimizer leaves unfused — a joined key
    dim of size 1, where the fused and unfused plans tie — runs
    ``torch.matmul`` and reaches no hand kernel."""
    from repro_torch.core.plan import infer
    out = []
    for root in compiled.roots:
        for n in postorder(root):
            if not (isinstance(n, FusedJoinAgg)
                    and n.join_kernel.name == "matMul"
                    and n.agg_kernel.name == "matAdd"):
                continue
            lt, rt = infer(n.left).rtype, infer(n.right).rtype
            kept_l = [f for d, f in enumerate(lt.key_shape)
                      if d not in n.join_keys_l]
            kept_r = [f for d, f in enumerate(rt.key_shape)
                      if d not in n.join_keys_r]
            joined = [lt.key_shape[d] for d in n.join_keys_l]
            out.append((math.prod(kept_l) * lt.bound[0],
                        math.prod(joined) * lt.bound[1],
                        math.prod(kept_r) * rt.bound[1]))
    return out


def chunk_launches(engine, splan, sms: int) -> dict:
    """The launches one streamed run of ``splan`` should read: for each
    chunk, the products of its program's plan that reach the matmul op
    (:func:`plan_products`), each on the route ``mm_ops.route`` gives its
    shape (``train_routes``, ``train_launches``).  The chunk programs are
    the engine's cached ones (a cache hit each)."""
    total = launches_of()
    for lo in range(0, splan.nkeys, splan.chunk_keys):
        n = min(splan.chunk_keys, splan.nkeys - lo)
        prog = engine.compile(_rebuild(splan.root, splan.sliced, n))
        one = train_launches(*train_routes(plan_products(prog), sms), 1)
        total = {k: total[k] + one[k] for k in total}
    return total


def held_launches(what, launches, expected) -> None:
    """The run's launch counts against the routes' (operand copies
    printed, not held: a streamed chunk is a fresh contiguous tensor)."""
    got = {k: v for k, v in launches.items() if k != "matmul_copies"}
    want = {k: v for k, v in expected.items() if k != "matmul_copies"}
    if got != want:
        fail(f"oocore {what}: launches {launches}, expected {expected}")


def stats_delta(before: dict, stats) -> dict:
    now = stats.as_dict()
    return {k: now[k] - before[k] for k in ("runs", "chunks", "h2d_bytes",
                                            "copy_s", "hidden_copy_s",
                                            "compute_s")}


def streamed_case(what, engine, z2, inputs, device, resident_inputs,
                  dims, ref, sms, expect) -> dict:
    """One streamed z2 through ``engine``: the first run with every launch
    count 0 just before and read just after, against the f64 result; then
    ``OOC_RUNS`` timed runs (no compile), the card's peak over the first
    run; the run's copy time and hidden share from the stream's events."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    out = engine.run(z2, **inputs)
    torch.cuda.synchronize(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    card_peak = torch.cuda.max_memory_allocated(device) - base \
        + resident_inputs
    (entry,) = [c for c in engine.cache_info() if c.stream_stats]
    stats = entry.stream_stats
    mode, chunks, ck = expect
    splan = StreamExecutor(engine).plan(z2)
    if (stats.mode, stats.chunks, splan.chunk_keys) != (mode, chunks, ck):
        fail(f"oocore {what}: mode {stats.mode}, {stats.chunks} chunks of "
             f"{splan.chunk_keys} keys; expected {mode}, {chunks} of {ck}")
    expected = chunk_launches(engine, splan, sms)
    held_launches(what, launches, expected)
    check = held(f"{what} z2 vs f64", out.data, ref, dims[2] * dims[6],
                 phase="oocore")
    first_stats = stats.as_dict()
    misses = engine.cache_misses
    before = stats.as_dict()
    ms = timed_runs(lambda: engine.run(z2, **inputs), device)
    delta = stats_delta(before, stats)
    if engine.cache_misses != misses:
        fail(f"oocore {what}: {engine.cache_misses - misses} compiles in "
             f"{OOC_RUNS} more runs")
    runs = delta["runs"]
    return {"out": out, "first_run_ms": first_ms, "ms": ms,
            "products_per_chunk": plan_products(engine.compile(_rebuild(
                splan.root, splan.sliced, splan.chunk_keys))),
            "median_ms": sorted(ms)[len(ms) // 2],
            "launches": launches, "check": check,
            "stats_first_run": first_stats,
            "h2d_bytes_per_run": delta["h2d_bytes"] / runs,
            "copy_ms_per_run": delta["copy_s"] * 1e3 / runs,
            "hidden_copy_ms_per_run": delta["hidden_copy_s"] * 1e3 / runs,
            "hidden_share": (delta["hidden_copy_s"] / delta["copy_s"]
                             if delta["copy_s"] else None),
            "compute_ms_per_run": delta["compute_s"] * 1e3 / runs,
            "copy_gb_s": (delta["h2d_bytes"] / delta["copy_s"] / 1e9
                          if delta["copy_s"] else None),
            "model_peak_bytes": stats.peak_device_bytes,
            "card_peak_bytes": card_peak, "budget_bytes": stats.budget_bytes,
            "cache": {"misses": engine.cache_misses,
                      "hits": engine.cache_hits}}


def streamed_refusal(z2, store, device) -> dict:
    """A ``TraReKey`` over the over-budget z2, compiled streamed with
    ``force=True`` (the ``degrade`` ladder's rung 1) under 1 GiB: under
    ``validate="strict"`` the ``NotStreamable`` carries the streaming
    pass's ``[streaming]`` diagnostic naming the rekey node; under
    ``"off"`` the bare refusal (``tests/test_analysis.py:435``)."""
    from repro_torch.core import Engine
    from repro_torch.core.guards import label_nodes
    from repro_torch.core.plan import TraReKey, as_node
    from repro_torch.store import NotStreamable
    rk = TraReKey(as_node(z2), lambda k: k)
    label = label_nodes((rk,))[id(rk)][1]
    texts = {}
    for mode in ("strict", "off"):
        eng = Engine(executor="jit", device=device, memory_budget=OOC_BUDGET,
                     store=store, validate=mode)
        try:
            eng._compile_streamed(rk, force=True)
        except NotStreamable as err:
            texts[mode] = str(err)
        else:
            fail(f"oocore: the rekeyed z2 streamed under validate={mode!r}")
    if "[streaming]" not in texts["strict"] or label not in texts["strict"]:
        fail(f"oocore: the strict refusal lacks [streaming] at {label}: "
             f"{texts['strict']!r}")
    if "[streaming]" in texts["off"]:
        fail(f"oocore: the refusal under validate='off' carries the "
             f"verifier's text: {texts['off']!r}")
    return {"label": label, "strict": texts["strict"].splitlines()[:3],
            "off": texts["off"]}


def phase_oocore(device) -> dict:
    """The §5.3 FFNN forward's z2 = relu(X·W1)·W2 at speech-100k streamed
    from a host ``RelationStore`` through ``Engine(memory_budget=...)``:
    W1 and W2 from the host under 1 GiB (stream-reduce over the hidden
    blocks), X from the host under 4 GiB (stream-out over its rows); then
    the ``degrade`` ladder: a real ``torch.OutOfMemoryError`` under a
    4 GiB cap recovered on rung 1, and a2 = σ(z2) under an injected OOM
    recovered on rung 2's halving chunks.  Every result within
    ``tolerance(k, f32)`` of the f64 product on the card."""
    import warnings
    from repro_torch.core import Engine, FaultInjector, from_tensor
    from repro_torch.core.cost import plan_peak_bytes
    from repro_torch.core.programs import _ffnn_forward
    from repro_torch.store import RelationStore
    from repro_torch.store.autotune import ENV_BUDGET
    t0 = time.perf_counter()
    rate = pinned_h2d_rate(device)
    cfg, dims, dense = train_problem(device)
    del dense["Y"]
    nb, db, hb, lb, bn, bd, bh, bl = dims
    tiles = {"X": (bn, bd), "W1": (bd, bh), "W2": (bh, bl)}
    rels = {k: from_tensor(dense[k], t) for k, t in tiles.items()}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fwd = _ffnn_forward(*dims)
    z2, a2 = fwd[5], fwd[6]
    ref = z2_relation(dims, z2_f64(dense))
    nbytes = {k: v.data.numel() * v.data.element_size()
              for k, v in rels.items()}

    # -- the resident z2 on the same engine kind -------------------------
    resident = Engine(executor="jit", device=device, validate="strict")
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    res_out = resident.run(z2, **rels)
    torch.cuda.synchronize(device)
    res_launches = read_launches()
    res_peak = torch.cuda.max_memory_allocated(device) - base \
        + sum(nbytes.values())
    res_check = held("resident z2 vs f64", res_out.data, ref,
                     dims[2] * dims[6], phase="oocore")
    res_ms = timed_runs(lambda: resident.run(z2, **rels), device)
    res_profile = device_profile(lambda: resident.run(z2, **rels),
                                 TRAIN_GROUPS)

    # -- 1. stream-reduce: W1 and W2 from the host under 1 GiB -----------
    store = RelationStore()
    p0 = time.perf_counter()
    host = {k: store.put(k, rels[k], split_dim=OOC_SPLIT[k])
            for k in ("W1", "W2")}
    put_s = time.perf_counter() - p0
    pinned = all(b.data.is_pinned() for h in host.values()
                 for b in h._blocks)
    if not pinned:
        fail("oocore: a store block is not page-locked")
    eng = Engine(executor="jit", device=device, memory_budget=OOC_BUDGET,
                 store=store, validate="strict")
    splan = StreamExecutor(eng).plan(z2)
    planned = {"mode": splan.mode, "dim": splan.dim,
               "input_dims": splan.input_dims,
               "chunk_keys": splan.chunk_keys, "nkeys": splan.nkeys,
               "chunk_plan_peak_bytes": plan_peak_bytes(_rebuild(
                   splan.root, splan.sliced, splan.chunk_keys)),
               "resident_plan_peak_bytes": plan_peak_bytes(z2)}
    red = streamed_case("stream-reduce", eng, z2,
                        {"X": rels["X"], **host}, device, nbytes["X"], dims,
                        ref, sms, ("stream-reduce", 10, 1))
    want_h2d = nbytes["W1"] + nbytes["W2"]
    if red["stats_first_run"]["h2d_bytes"] != want_h2d or \
            red["h2d_bytes_per_run"] != want_h2d:
        fail(f"oocore stream-reduce: {red['stats_first_run']['h2d_bytes']} "
             f"bytes to the card a run, expected {want_h2d}")
    if not 0 < red["model_peak_bytes"] <= OOC_BUDGET:
        fail(f"oocore stream-reduce: the model's peak "
             f"{red['model_peak_bytes']} over the budget {OOC_BUDGET}")
    red_profile = device_profile(lambda: eng.run(z2, X=rels["X"], **host),
                                 TRAIN_GROUPS)
    red["diagnostics"] = diag_counts(eng)
    refusal = streamed_refusal(z2, store, device)
    del eng, host, store

    # -- 2. stream-out: X from the host under 4 GiB ----------------------
    store = RelationStore()
    hx = store.put("X", rels["X"], split_dim=OOC_SPLIT["X"])
    eng = Engine(executor="jit", device=device,
                 memory_budget=OOC_OUT_BUDGET, store=store, validate="strict")
    out = streamed_case("stream-out", eng, z2,
                        {"X": hx, "W1": rels["W1"], "W2": rels["W2"]},
                        device, nbytes["W1"] + nbytes["W2"], dims, ref, sms,
                        ("stream-out", 3, 4))
    if out["out"].data.device != device:
        fail("oocore stream-out: the output is not on the card")
    if out["h2d_bytes_per_run"] != nbytes["X"]:
        fail(f"oocore stream-out: {out['h2d_bytes_per_run']} bytes to the "
             f"card a run, expected {nbytes['X']}")
    out["diagnostics"] = diag_counts(eng)
    del eng, hx, store

    # -- 3. rung 1 on a real OOM under a 4 GiB cap -----------------------
    host_np = {k: v.data.cpu().numpy() for k, v in rels.items()}
    for r in (red, out):
        del r["out"]
    del res_out, resident
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(device).total_memory
    env_before = os.environ.get(ENV_BUDGET)
    rung1 = {"cap_bytes": OOC_CAP, "allocated_before":
             torch.cuda.memory_allocated(device)}
    try:
        torch.cuda.set_per_process_memory_fraction(OOC_CAP / total, device)
        os.environ[ENV_BUDGET] = str(OOC_CAP)
        oom = None
        reset_launches()
        try:
            Engine(executor="jit", device=device,
                   validate="strict").run(z2, **host_np)
        except torch.OutOfMemoryError as err:
            oom = str(err).splitlines()[0][:160]
        if oom is None:
            fail("oocore rung 1: the resident z2 did not run out of memory "
                 "under the cap")
        # what the resident attempt launched before its allocation failed:
        # the degrade engine makes the same attempt first
        failed = read_launches()
        rung1.update({"oom": oom, "failed_attempt_launches": failed})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        eng = Engine(executor="jit", device=device, degrade=True,
                     validate="strict")
        reset_launches()
        with warnings.catch_warnings(record=True) as wlog:
            warnings.simplefilter("always")
            r1 = time.perf_counter()
            got = eng.run(z2, **host_np)
            torch.cuda.synchronize(device)
            rung1["ms"] = (time.perf_counter() - r1) * 1e3
        rung1["launches"] = read_launches()
        warns = [str(w.message)[:90] for w in wlog
                 if issubclass(w.category, RuntimeWarning)]
        (entry,) = [c for c in eng.cache_info() if c.stream_stats]
        st = entry.stream_stats
        rung1.update({"warnings": warns, "stats": st.as_dict(),
                      "peak_bytes": torch.cuda.max_memory_allocated(device)})
        if len(warns) != 1 or "host relation store" not in warns[0]:
            fail(f"oocore rung 1: warnings {warns}")
        if st.budget_bytes != OOC_CAP // 4 or st.runs != 1:
            fail(f"oocore rung 1: budget {st.budget_bytes}, runs {st.runs}")
        splan = StreamExecutor(eng).plan(z2, force=True)
        rung1["plan"] = {"mode": splan.mode, "chunk_keys": splan.chunk_keys,
                         "nkeys": splan.nkeys}
        if st.mode != splan.mode or st.chunks != splan.nchunks:
            fail(f"oocore rung 1: {st.mode} in {st.chunks} chunks, the "
                 f"planner's {splan.mode} in {splan.nchunks}")
        streamed = chunk_launches(eng, splan, sms)
        held_launches("rung 1", rung1["launches"],
                      {k: failed[k] + streamed[k] for k in streamed})
        rung1["check"] = held("rung 1 z2 vs f64", got.data, ref,
                              dims[2] * dims[6], phase="oocore")
        del got, eng
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, device)
        if env_before is None:
            os.environ.pop(ENV_BUDGET, None)
        else:
            os.environ[ENV_BUDGET] = env_before
    torch.cuda.empty_cache()

    # -- 4. rung 2: a2 under an injected OOM, down the halving chunks ----
    inj = FaultInjector().inject_oom(ok_chunk=OOC_LADDER_OK_CHUNK)
    eng = Engine(executor="jit", device=device, degrade=True,
                 fault_injector=inj, validate="strict")
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        r2 = time.perf_counter()
        got = eng.run(a2, **rels)
        torch.cuda.synchronize(device)
        rung2_ms = (time.perf_counter() - r2) * 1e3
    ooms = [d for k, d in inj.log if k == "oom"]
    chunks_failed = [int(d.rsplit("chunk=", 1)[1].split()[0])
                     for d in ooms if "chunk=" in d]
    if chunks_failed != [64, 32, 16]:
        fail(f"oocore rung 2: the ladder's failed chunks {chunks_failed}, "
             f"expected [64, 32, 16]")
    rung2 = {"ms": rung2_ms, "oom_log": ooms,
             "warnings": [str(w.message)[:90] for w in wlog],
             "launches": read_launches(),
             "peak_bytes": torch.cuda.max_memory_allocated(device),
             "check": held("rung 2 a2 vs sigmoid(f64 z2)", got.data,
                           torch.sigmoid(ref), dims[2] * dims[6],
                           phase="oocore")}
    del got, eng

    launches = {k: red["launches"].get(k, 0) + out["launches"].get(k, 0)
                + rung1["launches"].get(k, 0) for k in red["launches"]}
    result = {"phase": "oocore", "path": OOC_PATH,
              "width": [cfg.d_in, cfg.d_hidden, cfg.d_out],
              "batch": cfg.batch, "dims": list(dims), "h2d": rate,
              "put_s": put_s, "pinned_blocks": pinned, "plan": planned,
              "resident": {"ms": res_ms,
                           "median_ms": sorted(res_ms)[len(res_ms) // 2],
                           "launches": res_launches,
                           "card_peak_bytes": res_peak,
                           "check": res_check, "profile": res_profile},
              "stream_reduce": {**red, "profile": red_profile},
              "stream_out": out, "rung1": rung1, "rung2": rung2,
              "streamed_refusal": refusal,
              "launches": launches, "phase_s": time.perf_counter() - t0}
    emit(result)
    del rels, dense
    torch.cuda.empty_cache()
    return result


def visible_keys(sq: int, skv: int, causal: bool, window: int) -> np.ndarray:
    """The unmasked keys of each query row (row i stands at key position
    i + skv - sq)."""
    pos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(skv - 1, pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    return np.maximum(0, hi - lo + 1)


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: the work this input needs."""
    return int(visible_keys(sq, skv, causal, window).sum())


def flash_bound_times(b, hq, hkv, sq, skv, d, dv, dtype, causal,
                      window) -> tuple:
    """(bytes_ms, operations_ms) of one attention call on an H100 SXM: q,
    k, v read once and the output written once at the HBM rate, against
    2·(d + dv) operations per unmasked pair at the type's peak."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * hq * sq * d + b * hkv * skv * (d + dv)
              + b * hq * sq * dv) * isz
    flops = 2.0 * (d + dv) * b * hq * attention_pairs(sq, skv, causal,
                                                      window)
    return nbytes / H100_SXM.hbm_bw * 1e3, flops / PEAK[dtype] * 1e3


def bf16_half_step(m: torch.Tensor) -> torch.Tensor:
    """Half the spacing of bf16 numbers at magnitude ``m``, in f64:
    2^(e-8) for |m| in [2^e, 2^(e+1)) (bf16 keeps 8 significant bits)."""
    m = m.double().abs().clamp_min(2.0 ** -126)
    _, e = torch.frexp(m)                 # m = f·2^e with f in [0.5, 1)
    return torch.ldexp(torch.ones_like(m), e - 9)


def exact_gate(o, exact, delta=GEMMA2_BF16_DELTA) -> dict:
    """``o`` (a bf16 output, any float type) against ``exact`` (the f64
    attention): the outputs further from the exact value than half a bf16
    step at the larger of the two magnitudes plus ``delta``
    (``crossings``), and the largest excess over half a step."""
    o = o.double()
    excess = (o - exact).abs() - bf16_half_step(torch.maximum(o.abs(),
                                                              exact.abs()))
    return {"crossings": int((excess > delta).sum()),
            "max_excess_over_half_step": excess.max().item(),
            "delta": delta}


def flash_errors(o, r, dtype, atol=None, exact=None, rows=None) -> dict:
    """``o`` (the kernel's output) against ``r`` (the plain version's),
    both f32: elementwise within ``atol + rtol·|r|`` (both ``FLASH_TOL``,
    or ``atol`` alone when given) — or, when ``exact`` (the f64 attention)
    is given, within :func:`exact_gate` of it — and each row's error
    within ``ROW_REL_TOL`` of that row's norm (only the rows where
    ``rows``, a bool mask over the second-last dim, is true, when given).
    ``fault`` says what failed, or is None."""
    rtol, atol = (FLASH_TOL[dtype],) * 2 if atol is None else (0.0, atol)
    err = (o - r).abs()
    # a fully masked row is 0 in both: 0 / tiny = 0
    row_err = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    row_rel = (row_err if rows is None else row_err[..., rows]).max().item()
    gate = exact_gate(o, exact) if exact is not None else None
    out = gate if gate else {"rtol": rtol, "atol": atol}
    fault = None
    if not bool(torch.isfinite(o).all()):
        fault = "output not finite"
    elif gate and gate["crossings"]:
        fault = (f"{gate['crossings']} outputs further than half a bf16 "
                 f"step + {gate['delta']} from the exact attention (largest "
                 f"excess {gate['max_excess_over_half_step']})")
    elif not gate and bool((err > atol + rtol * r.abs()).any()):
        fault = f"max |err| {err.max().item()} over rtol={rtol} atol={atol}"
    elif not row_rel <= ROW_REL_TOL[dtype]:
        fault = (f"a row's error is {row_rel} of its norm, over "
                 f"{ROW_REL_TOL[dtype]}")
    return {"max_abs_err": err.max().item(), **out, "max_row_rel_err": row_rel,
            "row_rel_tol": ROW_REL_TOL[dtype], "fault": fault}


def flash_case(b, hq, hkv, sq, skv, d, dv, dtype, kw, device, gen,
               iters=0, atol=None, exact=False) -> dict:
    """The kernel against ``attention_ref`` on one input
    (:func:`flash_errors`; elementwise against the f64 attention of the
    same inputs when ``exact``); timed (kernel, plain, bound) when
    ``iters`` > 0."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, dv)
    before = (flash_ops.TC_LAUNCHES, flash_ops.FFMA_LAUNCHES)
    out = flash_ops.attention(q, k, v, impl="kernel", **kw)
    routed = (flash_ops.TC_LAUNCHES - before[0],
              flash_ops.FFMA_LAUNCHES - before[1])
    ref = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize(device)
    name = f"attention b{b} h{hq}/{hkv} s{sq}/{skv} d{d}/{dv} {dtype} {kw}"
    if routed != ((1, 0) if dtype == torch.bfloat16 else (0, 1)):
        fail(f"{name}: (tensor-core, FFMA) launches {routed}")
    if tuple(out.shape) != (b, hq, sq, dv) or out.dtype != dtype:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype}")
    o, r = out.float(), ref.float()
    del out, ref
    ex = exact_attention(q, k, v, rows=512, **kw) if exact else None
    errs = flash_errors(o, r, dtype, atol, ex)
    del ex
    fault = errs.pop("fault")
    if fault is not None:
        fail(f"{name}: {fault}")
    row = {"b": b, "hq": hq, "hkv": hkv, "sq": sq, "skv": skv, "d": d,
           "dv": dv, "dtype": str(dtype).split(".")[-1],
           "kernel": "wgmma" if routed[0] else "ffma", **kw, **errs,
           "max_abs_ref": r.abs().max().item(),
           "mean_abs_ref": r.abs().mean().item()}
    del o, r
    if iters:
        t_bytes, t_ops = flash_bound_times(b, hq, hkv, sq, skv, d, dv, dtype,
                                           kw["causal"], kw["window"])
        bnd, by = bound_of(t_bytes, t_ops)
        row.update({
            "kernel_ms": timed_ms(lambda: flash_ops.attention(
                q, k, v, impl="kernel", **kw), device, iters, warmup=1),
            "plain_ms": timed_ms(lambda: attention_ref(q, k, v, **kw),
                                 device, max(1, iters // 2), warmup=1),
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops})
    return row


def gemma2_layer_kw(cfg, layer: int) -> dict:
    """The attention settings of one layer, as the model hands them on."""
    return {"causal": True,
            "window": _window_for(cfg, layer % group_size(cfg)),
            "softcap": cfg.attn_softcap}


def phase_flash(device, gen) -> dict:
    rows = []
    # the JAX kernel tests' cases (tests/test_kernels.py:47-76)
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((4, 4), (8, 2)):
            for causal, window, softcap in ((True, 0, 0.0), (True, 64, 0.0),
                                            (True, 0, 30.0),
                                            (False, 0, 0.0)):
                rows.append(flash_case(
                    2, hq, hkv, 256, 256, 64, 64, dtype,
                    {"causal": causal, "window": window, "softcap": softcap},
                    device, gen))
    # ragged lengths, sq < skv (ends aligned), dv != d
    causal = {"causal": True, "window": 0, "softcap": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(flash_case(2, 8, 4, 200, 200, 64, 64, dtype, causal,
                               device, gen))
        rows.append(flash_case(2, 8, 4, 1000, 1000, 64, 64, dtype,
                               {"causal": True, "window": 100,
                                "softcap": 30.0}, device, gen))
        rows.append(flash_case(2, 8, 4, 100, 300, 64, 64, dtype, causal,
                               device, gen))
        rows.append(flash_case(2, 8, 4, 200, 200, 192, 128, dtype, causal,
                               device, gen))
    for r in rows:
        emit({"phase": "flash", **r})
    # gemma2-2b's two layer shapes: bf16 as the model runs them, timed;
    # f32 at the same shapes, the global one timed (the FFMA kernel's row)
    cfg = get_config(ARCH)
    dims = (PROMPT_BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT_LEN,
            PROMPT_LEN, cfg.head_dim, cfg.head_dim)
    layers = {}
    for kind, layer in (("window", 0), ("global", 1)):
        kw = gemma2_layer_kw(cfg, layer)
        layers[kind] = flash_case(*dims, torch.bfloat16, kw, device, gen,
                                  iters=4, exact=True)
        emit({"phase": "flash", "at": f"{ARCH} {kind} layer",
              **layers[kind]})
        rows.append(flash_case(*dims, torch.float32, kw, device, gen,
                               iters=2 if kind == "global" else 0,
                               atol=FLASH_TOL[torch.float32]))
        emit({"phase": "flash", "at": f"{ARCH} {kind} layer, f32",
              **rows[-1]})
        if kind == "global":
            layers["global_f32"] = rows[-1]
    library = {dt: flash_library_case(*dims, dt, device, gen)
               for dt in (torch.bfloat16, torch.float32)}
    for row in library.values():
        emit({"phase": "flash", **row})
    rounding = flash_rounding(cfg, device)
    emit({"phase": "flash", **rounding})
    # zamba2-7b's shared attention (MHA 32/32 of dim 112, which the
    # tensor-core kernel pads to 128; causal, no window, no soft-cap), held
    # as gemma2's shapes are, from a generator of its own, so that the
    # later phases draw what they drew
    zgen = torch.Generator(device=device).manual_seed(SEED + 21)
    zdims, zkw = hybrid_attention(get_config(HYBRID_ARCH))
    layers["zamba2"] = flash_case(*zdims, torch.bfloat16, zkw, device, zgen,
                                  iters=4, exact=True)
    emit({"phase": "flash", "at": f"{HYBRID_ARCH} shared attention",
          **layers["zamba2"]})
    rows.append(flash_case(*zdims, torch.float32, zkw, device, zgen, iters=2,
                           atol=FLASH_TOL[torch.float32]))
    layers["zamba2_f32"] = rows[-1]
    emit({"phase": "flash", "at": f"{HYBRID_ARCH} shared attention, f32",
          **rows[-1]})
    zlib = flash_library_case(*zdims, torch.bfloat16, device, zgen,
                              at=f"{HYBRID_ARCH} shared attention shape")
    emit({"phase": "flash", **zlib})
    return {"rows": rows, "layers": layers, "library": library,
            "rounding": rounding, "zamba2_library": zlib}


def hybrid_attention(cfg) -> tuple:
    """The dims and settings of zamba2-7b's attention calls in the prefill
    (every shared-block application): (B, Hq, Hkv, Sq, Skv, D, Dv) and the
    keywords."""
    return ((HYBRID_BATCH, cfg.n_heads, cfg.n_kv_heads, PROMPT_LEN,
             PROMPT_LEN, cfg.head_dim, cfg.head_dim),
            {"causal": True, "window": 0, "softcap": cfg.attn_softcap})


def exact_attention(q, k, v, *, causal, window, softcap, scale=None,
                    rows=None):
    """``attention_ref``'s function computed in f64: the yardstick that
    both the kernel and the plain version round from.  Computed in blocks
    of ``rows`` query rows (all at once when None), so that the f64 scores
    of a long sequence stay within memory."""
    group = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else q.shape[3] ** -0.5
    kd = k.double().repeat_interleave(group, 1)
    vd = v.double().repeat_interleave(group, 1)
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    step = rows or q.shape[2]
    out = []
    for r0 in range(0, q.shape[2], step):
        qb = q[:, :, r0:r0 + step].double()
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kd) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        pos = torch.arange(r0, r0 + qb.shape[2], device=q.device)[:, None] \
            + (k.shape[2] - q.shape[2])
        mask = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            mask &= pos >= cols
        if window > 0:
            mask &= pos - cols < window
        p = torch.softmax(s.masked_fill(~mask, float("-inf")),
                          -1).nan_to_num(0.0)
        del s
        out.append(torch.einsum("bhqk,bhkd->bhqd", p, vd))
    return torch.cat(out, 2)


def rounded_off(o, exact) -> int:
    """How many of ``o``'s elements differ from ``exact`` rounded to
    ``o``'s type."""
    return int((o != exact.to(o.dtype)).sum())


def flash_rounding(cfg, device, seeds: int = 8, s: int = 256) -> dict:
    """The bf16 kernel's rounding against the plain f32 version's, at
    gemma2-2b's head shape and soft-cap, causal, over the first ``s`` rows
    (``seeds`` draws): elements that differ from the correctly rounded
    f64 attention, within ``FLASH_ROUNDING_FACTOR`` of the plain count.
    (How often a fresh draw takes a kernel past the gemma2 gate:
    ``tools/flash_gate_census.py``.)"""
    kw = gemma2_layer_kw(cfg, 1)
    shapes = ((PROMPT_BATCH, cfg.n_heads, s, cfg.head_dim),
              (PROMPT_BATCH, cfg.n_kv_heads, s, cfg.head_dim),
              (PROMPT_BATCH, cfg.n_kv_heads, s, cfg.head_dim))
    kernel_off = plain_off = 0
    for i in range(seeds):
        g = torch.Generator(device=device).manual_seed(SEED + i)
        q, k, v = (torch.randn(sh, generator=g, device=device).bfloat16()
                   for sh in shapes)
        exact = exact_attention(q, k, v, **kw)
        kernel_off += rounded_off(
            flash_ops.attention(q, k, v, impl="kernel", **kw), exact)
        plain_off += rounded_off(attention_ref(q, k, v, **kw), exact)
    ratio = kernel_off / max(plain_off, 1)
    if not ratio <= FLASH_ROUNDING_FACTOR:
        fail(f"flash rounding: the bf16 kernel's outputs differ from the "
             f"exact ones {kernel_off} times, the plain version's "
             f"{plain_off}: {ratio:.2f}x > {FLASH_ROUNDING_FACTOR}")
    return {"at": f"{ARCH} head shape, first {s} rows, {seeds} seeds",
            "outputs": seeds * PROMPT_BATCH * cfg.n_heads * s * cfg.head_dim,
            "off_exact": {"wgmma": kernel_off, "plain": plain_off},
            "ratio": ratio, "limit": FLASH_ROUNDING_FACTOR}


def flash_library_case(b, hq, hkv, s, _, d, dv, dt, device, gen,
                       at=f"{ARCH} global layer shape, no soft-cap") -> dict:
    """The library yardstick: one PyTorch call computing the same function
    at one shape without soft-cap (gemma2's global shape: no single call
    applies the soft-cap), timed beside the kernel that ``dt`` routes
    to."""
    q = torch.randn((b, hq, s, d), generator=gen, device=device).to(dt)
    k = torch.randn((b, hkv, s, d), generator=gen, device=device).to(dt)
    v = torch.randn((b, hkv, s, dv), generator=gen, device=device).to(dt)
    nocap = {"causal": True, "window": 0, "softcap": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    ker_out = flash_ops.attention(q, k, v, impl="kernel", **nocap)
    lib_err = (lib_out.float() - ker_out.float()).abs().max().item()
    del lib_out, ker_out
    iters = 4 if dt == torch.bfloat16 else 2
    return {
        "at": at,
        "dtype": str(dt).split(".")[-1],
        "kernel": "wgmma" if dt == torch.bfloat16 else "ffma",
        "library_call": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)",
        "library_ms": timed_ms(lambda: sdpa(q, k, v, is_causal=True,
                                            enable_gqa=True), device, iters,
                               warmup=1),
        "kernel_ms": timed_ms(lambda: flash_ops.attention(
            q, k, v, impl="kernel", **nocap), device, iters, warmup=1),
        "max_abs_diff": lib_err}


def device_profile(fn, groups=MODEL_GROUPS) -> dict:
    """Device time of ``fn()`` by kernel (``torch.profiler``), grouped by
    the first of ``groups`` whose name parts a kernel's name holds (by
    default the flash kernel, the SSD kernel, the GEMMs — cuBLAS:
    projections, MLP, unembedding) and the rest, beside the host-clock
    wall time of the profiled call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3
            launches += e.count
    totals = {name: 0.0 for name, _ in groups}
    totals["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, parts in groups
                      if any(p in low for p in parts)), "other")
        totals[group] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "kernel_launches": launches,
            "device_ms_by_group": totals,
            "device_ms_total": busy,
            "device_busy_share": busy / wall_ms if busy else None,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def compare_with_plain(cfg, model, prompts, run, impls=("attn_impl",),
                       what_path="gemma2", limits=None) -> dict:
    """The same model with the plain versions of its kernels (``impls``:
    ``attn_impl`` for the attention, ``ssd_impl`` for the SSD scan), fed
    the kernel run's tokens: its prefill and first decode logits against
    the kernel run's (every logit finite, and within ``limits[what]``, by
    default ``0.02·(max|logit| + 1)``), the share of greedy tokens on
    which the two agree, and the host-clock time of the plain run's
    prefill."""
    from repro_torch.models import decode_step, prefill
    batch = prompts.shape[0]
    for attr in impls:
        setattr(model, attr, "plain")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_logits, cache = prefill(cfg, model, {"tokens": prompts},
                                      prompts.shape[1] + GEN)
        torch.cuda.synchronize()
        plain_prefill_ms = (time.perf_counter() - t0) * 1e3
        first_token = run.prefill_logits.argmax(-1)
        tok, agree, plain_first = first_token, 0, None
        for t in range(GEN):
            logits, cache = decode_step(cfg, model, cache, {"token": tok})
            if plain_first is None:
                plain_first = logits
            want = run.tokens[:, t:t + 1].to(prompts.device)
            agree += int((logits.argmax(-1) == want).sum())
            tok = want
    for attr in impls:
        setattr(model, attr, "auto")
    checks = {}
    for what, got, ref in (("prefill", run.prefill_logits, plain_logits),
                           ("decode_step_1", run.first_decode_logits,
                            plain_first)):
        shape = (batch, 1, cfg.vocab_size)
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            fail(f"{what_path} {what}: logits of shape {tuple(got.shape)} / "
                 f"not finite")
        diff = (got - ref).abs().max().item()
        bound = (limits[what] if limits else
                 0.02 * (ref.abs().max().item() + 1.0))
        checks[what] = {"max_abs_diff_vs_plain": diff, "bound": bound}
        if not diff <= bound:
            fail(f"{what_path} {what}: logits differ from the plain-kernel "
                 f"run by {diff} > {bound}")
    return {"checks": checks,
            "first_token_agrees": bool(torch.equal(
                first_token, plain_logits.argmax(-1))),
            "greedy_tokens_agree_share": agree / (batch * GEN),
            "plain_prefill_ms": plain_prefill_ms}


def launches_per_prefill(cfg) -> dict:
    """The model kernels' launches in one prefill of ``cfg``: flash
    attention once per attention layer (dense) or shared-block application
    (hybrid), the SSD scan once per Mamba2 layer (ssm, hybrid)."""
    flash = {"dense": cfg.n_layers, "ssm": 0,
             "hybrid": n_scan_groups(cfg)}[cfg.family]
    return {"flash_attention": flash,
            "ssd_scan": 0 if cfg.family == "dense" else cfg.n_layers}


def path_profiles(cfg, model, prompts, what_path="gemma2") -> dict:
    """One prefill, then 8 decode steps as ``dense_generate``'s loop takes
    them, each under the profiler, with the launches of the flash and SSD
    kernels (``ops.LAUNCHES``) in each: :func:`launches_per_prefill` in
    the prefill, none in decode."""
    ops = {"flash_attention": flash_ops, "ssd_scan": ssd_ops}
    from repro_torch.models import decode_step, prefill
    state = {}

    def prefill_once():
        state["logits"], state["cache"] = prefill(
            cfg, model, {"tokens": prompts}, prompts.shape[1] + 8)

    def decode_8_steps():
        cache, tok = state["cache"], state["logits"].argmax(-1)
        for _ in range(8):
            logits, cache = decode_step(cfg, model, cache, {"token": tok})
            tok = logits.argmax(-1)
            tok.cpu()

    def counts():
        return {name: m.LAUNCHES for name, m in ops.items()}

    with torch.inference_mode():
        n0 = counts()
        pre = device_profile(prefill_once)
        n1 = counts()
        dec = device_profile(decode_8_steps)
        n2 = counts()
    by_phase = {"prefill": {k: n1[k] - n0[k] for k in ops},
                "decode_8_steps": {k: n2[k] - n1[k] for k in ops}}
    want = {"prefill": launches_per_prefill(cfg),
            "decode_8_steps": {k: 0 for k in ops}}
    if by_phase != want:
        fail(f"{what_path}: kernel launches by phase {by_phase}; expected "
             f"{want}")
    return {"launches_by_phase": by_phase, "profile_prefill": pre,
            "profile_decode_8_steps": dec}


def decode_step_bound_ms(cfg, model, batch) -> float:
    """The least time of the last decode step: every weight read once,
    each attention's visible KV cache (PROMPT_LEN + GEN positions, or its
    window) read once, and each Mamba2 layer's conv and SSM state read and
    written once, at the HBM rate."""
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    isz = model.embed["w"].element_size()
    seen = PROMPT_LEN + GEN
    k_and_v = 2 * batch * cfg.n_kv_heads * cfg.head_dim * isz
    if cfg.family == "dense":
        windows = [gemma2_layer_kw(cfg, i)["window"]
                   for i in range(cfg.n_layers)]
    else:
        windows = [0] * launches_per_prefill(cfg)["flash_attention"]
    cache_bytes = sum(k_and_v * (min(seen, w) if w else seen)
                      for w in windows)
    if cfg.family != "dense":
        gn = cfg.ssm_ngroups * cfg.ssm_state
        state = batch * (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
                         + (cfg.ssm_conv_width - 1)
                         * (cfg.d_inner + 2 * gn) * isz)
        cache_bytes += 2 * cfg.n_layers * state
    return (weight_bytes + cache_bytes) / H100_SXM.hbm_bw * 1e3


def phase_gemma2(device) -> dict:
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import init_params
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (PROMPT_BATCH, PROMPT_LEN),
                            generator=gen, device=device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    dense_generate(cfg, model, prompts[:, :256], 2)     # warm: CUDA/cuBLAS
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    run = dense_generate(cfg, model, prompts, GEN)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    # one per layer, all on the tensor-core kernel and with no copy of q, k
    # or v; path_profiles shows a lone prefill makes them all
    expected = launches_of(flash_attention=cfg.n_layers,
                           flash_attention_wgmma=cfg.n_layers)
    if launches != expected:
        fail(f"gemma2: launches {launches}; expected {expected}")
    out = {"phase": "gemma2", "arch": ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": PROMPT_BATCH, "prompt_len": PROMPT_LEN, "gen": GEN,
           "launches": launches,
           "prefill_ms": run.prefill_s * 1e3,
           "decode_tok_per_s": PROMPT_BATCH * GEN / run.decode_s,
           "decode_ms_per_step": run.decode_s * 1e3 / GEN,
           "decode_step_bytes_bound_ms": decode_step_bound_ms(
               cfg, model, PROMPT_BATCH),
           "max_memory_allocated_gb": peak / 1e9,
           **compare_with_plain(cfg, model, prompts, run),
           "setup_s": setup_s, **path_profiles(cfg, model, prompts)}
    emit(out)
    return out


FLASH_CSRC = "src/repro_torch/kernels/flash_attention/csrc/"


def by_path(kernel: str, **paths) -> dict:
    """A kernel's launches on each main path that runs it."""
    return {paths[name]["arch"]: paths[name]["launches"][kernel]
            for name in paths}


def path_entry(layer: dict, **extra) -> dict:
    """One layer shape's numbers of a kernels-line entry."""
    return {**{k: layer[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                     "bound_by")}, **extra}


def flash_entries(flash: dict, gemma2: dict, zamba2: dict) -> list:
    """The kernels line's two flash attention entries.  The tensor-core
    kernel (bf16, the main paths): one launch at gemma2-2b's global-layer
    shape, the window layer, zamba2-7b's shared attention and a whole
    prefill of each beside it.  The FFMA kernel (f32 only, off the main
    paths): one launch at gemma2's global shape and at zamba2's in f32."""
    cfg = get_config(ARCH)
    glob, win = flash["layers"]["global"], flash["layers"]["window"]
    g32 = flash["layers"]["global_f32"]
    z16, z32 = flash["layers"]["zamba2"], flash["layers"]["zamba2_f32"]
    zlib = flash["zamba2_library"]
    z_apps = zamba2["shared_block_applications"]
    n_win = sum(gemma2_layer_kw(cfg, i)["window"] > 0
                for i in range(cfg.n_layers))
    n_glob = cfg.n_layers - n_win
    lib, lib32 = (flash["library"][dt]
                  for dt in (torch.bfloat16, torch.float32))
    rows = {kind: [r for r in flash["rows"] + [glob, win, z16]
                   if r["kernel"] == kind] for kind in ("wgmma", "ffma")}
    shape = (f"B={PROMPT_BATCH}, Hq={cfg.n_heads}, Hkv={cfg.n_kv_heads}, "
             f"S={PROMPT_LEN}, D={cfg.head_dim}, causal, soft-cap "
             f"{cfg.attn_softcap}")
    common = {"route": "cuda",
              "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
              "function": "flash_attention_pallas"}
    dp = flash_ops.padded_dim(z16["d"], z16["dv"])
    zshape = (f"B={HYBRID_BATCH}, Hq=Hkv={z16['hq']}, S={PROMPT_LEN}, "
              f"D={z16['d']} (padded to {dp}), causal, no soft-cap")
    zprefill = {"kernel_ms": zamba2["profile_prefill"]["device_ms_by_group"][
                    "flash_attention"],
                "launches": z_apps, "bound_ms": z_apps * z16["bound_ms"]}
    wgmma_paths = by_path("flash_attention_wgmma", gemma2=gemma2,
                          zamba2=zamba2)
    return [{
        "name": "flash_attention_wgmma", **common,
        "source": FLASH_CSRC + "flash_attention_wgmma.cu",
        "launches": sum(wgmma_paths.values()),
        "launches_by_path": wgmma_paths,
        "max_abs_err": max(r["max_abs_err"] for r in rows["wgmma"]),
        "ms": glob["kernel_ms"], "plain_ms": glob["plain_ms"],
        "bound_ms": glob["bound_ms"], "bound_by": glob["bound_by"],
        "library_ms": lib["library_ms"],
        "kernel_no_softcap_ms": lib["kernel_ms"],
        "library_call": lib["library_call"] + ", no soft-cap",
        "window_layer": {k: win[k] for k in ("kernel_ms", "plain_ms",
                                             "bound_ms", "bound_by")},
        "prefill": {
            "kernel_ms": gemma2["profile_prefill"]["device_ms_by_group"][
                "flash_attention"],
            "bound_ms": n_glob * glob["bound_ms"] + n_win * win["bound_ms"],
            "prefill_ms": gemma2["prefill_ms"],
            "plain_prefill_ms": gemma2["plain_prefill_ms"]},
        HYBRID_ARCH: path_entry(
            z16, library_ms=zlib["library_ms"],
            library_kernel_ms=zlib["kernel_ms"], prefill=zprefill,
            at=f"one launch at the shared attention's shape ({zshape}); "
               f"library_ms: the same function, library_kernel_ms the "
               f"kernel beside it; prefill: the kernel's device time in a "
               f"profiled prefill and its bound"),
        "at": f"bf16, the main path: one launch at the {ARCH} global-layer "
              f"shape ({shape}); library_ms and kernel_no_softcap_ms at "
              f"that shape with no soft-cap (no single PyTorch call "
              f"computes the soft-capped function); prefill: the kernel's "
              f"device time in a profiled prefill ({n_glob} global + "
              f"{n_win} window launches), their bound, and the prefill on "
              f"the kernel and on the plain attention"}, {
        "name": "flash_attention_ffma", **common,
        "source": FLASH_CSRC + "flash_attention.cu",
        "launches": sum(by_path("flash_attention_ffma", gemma2=gemma2,
                                zamba2=zamba2).values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows["ffma"]),
        "ms": g32["kernel_ms"], "plain_ms": g32["plain_ms"],
        "bound_ms": g32["bound_ms"], "bound_by": g32["bound_by"],
        "library_ms": lib32["library_ms"],
        "kernel_no_softcap_ms": lib32["kernel_ms"],
        "library_call": lib32["library_call"] + ", f32, no soft-cap",
        HYBRID_ARCH: path_entry(z32, at=f"f32, {zshape}"),
        "at": f"f32 only, off the main path (0 launches there): one launch "
              f"at the {ARCH} global-layer shape in f32 ({shape}); the "
              f"bound at the f32 FFMA peak; library_ms and "
              f"kernel_no_softcap_ms at that shape with no soft-cap"}]


def ssd_inputs(b, s, h, p, n, dtype, device, gen, strided=True) -> tuple:
    """x, dt, A, B, C as the JAX kernel tests draw them (x, B, C normal in
    ``dtype``, dt = softplus(normal), A = -exp(normal), both f32); B and C
    are the two halves of one (b, s, 2n) tensor, as the model hands them
    over, unless ``strided`` is false."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = rnd(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h))
    bcc = rnd(b, s, 2 * n).to(dtype)
    bm, cm = bcc[..., :n], bcc[..., n:]
    if not strided:
        bm, cm = bm.contiguous(), cm.contiguous()
    return x, dt, A, bm, cm


def ssd_errors(o, r, dtype) -> dict:
    """``o`` (the kernel's output) against ``r`` (the plain version's), both
    f32: max |err| within ``SSD_TOL·max|r|``, and each (b, s, h) row's
    error within ``SSD_ROW_TOL`` of that row's norm.  ``fault`` says what
    failed, or is None."""
    err = (o - r).abs()
    atol = SSD_TOL[dtype] * r.abs().max().item()
    row_rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
               ).max().item()
    fault = None
    if not bool(torch.isfinite(o).all()):
        fault = "output not finite"
    elif not err.max().item() <= atol:
        fault = f"max |err| {err.max().item()} over {atol}"
    elif not row_rel <= SSD_ROW_TOL[dtype]:
        fault = (f"a row's error is {row_rel} of its norm, over "
                 f"{SSD_ROW_TOL[dtype]}")
    return {"max_abs_err": err.max().item(), "atol": atol,
            "max_row_rel_err": row_rel, "row_rel_tol": SSD_ROW_TOL[dtype],
            "fault": fault}


def ssd_bound_times(b, s, h, p, n, chunk, dtype) -> tuple:
    """(bytes_ms, operations_ms) of one SSD scan on an H100 SXM: x, dt, B,
    C read once and y written once at the HBM rate, against the unmasked
    work at the type's peak: C·B over the lower triangle of each chunk
    (once per batch row: B and C are shared by the heads), and per head
    the decayed scores times x·dt, C·h and the state update."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * b * s * h * p * isz + b * s * h * 4 + 2 * b * s * n * isz \
        + h * 4
    lens = [min(chunk, s - s0) for s0 in range(0, s, chunk)]
    pairs = sum(L * (L + 1) // 2 for L in lens)
    flops = b * 2.0 * n * pairs + b * h * (2.0 * p * pairs
                                           + 4.0 * s * n * p)
    return nbytes / H100_SXM.hbm_bw * 1e3, flops / PEAK[dtype] * 1e3


def exact_ssd(x, dt, A, Bm, Cm, chunk) -> tuple:
    """``(y, h_S)`` of the plain chunked scan computed in f64 from the same
    inputs: the exact result that every per-call SSD check holds the
    kernels to (the f32 plain version sums C·Bᵀ as JAX does, and loses a
    few % of a row whose C_i·B_i cancels)."""
    return ssd_chunked_ref(*(t.double() for t in (x, dt, A, Bm, Cm)), chunk,
                           final_state=True)


def ssd_state_errors(hk, x, dt, A, bm, cm, dtype, exact=None) -> dict:
    """The kernel's final state ``hk`` against ``ssd_final_state`` on the
    same inputs, max |err| within ``SSD_TOL·max|h|``, and against the f64
    state ``exact`` (:func:`exact_ssd`'s, computed here when not given),
    within ``SSD_STATE_TOL`` of its largest |h|; beside them,
    ``ssd_final_state``'s own distance to the f64 state (an f32 cumsum over
    the whole sequence, whose own rounding grows with S).  ``fault`` says
    what failed, or is None."""
    href = ssd_ops.ssd_final_state(x, dt, A, bm, cm)
    if exact is None:
        exact = exact_ssd(x, dt, A, bm, cm, min(128, x.shape[1]))[1]
    top = exact.abs().max().item()
    err = (hk - href).abs().max().item()
    atol = SSD_TOL[dtype] * href.abs().max().item()
    rel = (hk.double() - exact).abs().max().item() / top
    fault = None
    if not bool(torch.isfinite(hk).all()):
        fault = "final state not finite"
    elif not err <= atol:
        fault = f"final state: max |err| {err} over {atol}"
    elif not rel <= SSD_STATE_TOL:
        fault = (f"final state: {rel} of max|h| off the f64 state, over "
                 f"{SSD_STATE_TOL}")
    return {"state_max_abs_err": err, "state_atol": atol,
            "state_vs_f64_rel": rel, "state_f64_tol": SSD_STATE_TOL,
            "final_state_fn_vs_f64_rel":
                (href.double() - exact).abs().max().item() / top,
            "fault": fault}


def ssd_case(b, s, h, p, n, chunk, dtype, device, gen, iters=0,
             strided=True, state=False) -> dict:
    """The kernel that ``dtype`` routes to (bf16: the tensor-core kernel,
    f32: the FFMA kernel) against the exact result on one input
    (:func:`exact_ssd`, :func:`ssd_errors`); with ``state``, its final
    state from the same launch against ``ssd_final_state`` and the f64
    state (:func:`ssd_state_errors`); timed (kernel, plain, bound) when
    ``iters`` > 0."""
    x, dt, A, bm, cm = ssd_inputs(b, s, h, p, n, dtype, device, gen,
                                  strided)
    before = (ssd_ops.TC_LAUNCHES, ssd_ops.FFMA_LAUNCHES)
    out = ssd_ops.ssd_scan(x, dt, A, bm, cm, chunk=chunk, impl="kernel",
                           return_final_state=state)
    routed = (ssd_ops.TC_LAUNCHES - before[0],
              ssd_ops.FFMA_LAUNCHES - before[1])
    out, hk = out if state else (out, None)
    ref, exact_h = exact_ssd(x, dt, A, bm, cm, min(chunk, s))
    torch.cuda.synchronize(device)
    name = f"ssd_scan b{b} s{s} h{h} p{p} n{n} chunk{chunk} {dtype}"
    if routed != ((1, 0) if dtype == torch.bfloat16 else (0, 1)):
        fail(f"{name}: (tensor-core, FFMA) launches {routed}")
    if out.shape != x.shape or out.dtype != dtype:
        fail(f"{name}: got {tuple(out.shape)} {out.dtype}")
    o, r = out.float(), ref.float()
    del out, ref
    errs = ssd_errors(o, r, dtype)
    fault = errs.pop("fault")
    if fault is not None:
        fail(f"{name}: {fault}")
    row = {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
           "dtype": str(dtype).split(".")[-1], "bc_strided": strided,
           "kernel": "wgmma" if routed[0] else "ffma", **errs,
           "max_abs_ref": r.abs().max().item(),
           "mean_abs_ref": r.abs().mean().item()}
    del o, r
    if state:
        serr = ssd_state_errors(hk, x, dt, A, bm, cm, dtype, exact_h)
        if serr.pop("fault") is not None:
            fail(f"{name}: final state off ssd_final_state: {serr}")
        row.update(serr)
        del hk
    if iters:
        t_bytes, t_ops = ssd_bound_times(b, s, h, p, n, chunk, dtype)
        bnd, by = bound_of(t_bytes, t_ops)
        row.update({
            "kernel_ms": timed_ms(lambda: ssd_ops.ssd_scan(
                x, dt, A, bm, cm, chunk=chunk, impl="kernel"), device, iters,
                warmup=1),
            "plain_ms": timed_ms(lambda: ssd_chunked_ref(x, dt, A, bm, cm,
                                                         chunk),
                                 device, max(1, iters // 2), warmup=1),
            "bound_ms": bnd, "bound_by": by, "bytes_ms": t_bytes,
            "operations_ms": t_ops})
    return row


def phase_ssd(device, gen) -> dict:
    rows = []
    # the JAX kernel tests' cases (tests/test_kernels.py:107-139), ragged S,
    # S < chunk, N and P that are not multiples of 4, contiguous B and C;
    # bf16 through the tensor-core kernel, f32 through the FFMA kernel
    cases = [(2, 64, 4, 16, 8, 16), (2, 128, 4, 16, 8, 32),
             (2, 96, 4, 16, 8, 32), (1, 64, 2, 16, 8, 32),
             (1, 128, 2, 16, 8, 64), (2, 200, 4, 16, 8, 64),
             (2, 40, 3, 16, 8, 128), (1, 77, 2, 22, 13, 16)]
    for dtype in (torch.float32, torch.bfloat16):
        for c in cases:
            rows.append(ssd_case(*c, dtype, device, gen))
        rows.append(ssd_case(2, 300, 4, 64, 128, 128, dtype, device, gen,
                             strided=False))
    for r in rows:
        emit({"phase": "ssd", **r})
    # mamba2-130m's layer shape: bf16 as the model runs it, timed, with its
    # final state; f32 at the same shape through the FFMA kernel, timed
    cfg = get_config(SSM_ARCH)
    dims = (SSM_BATCH, PROMPT_LEN, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_chunk)
    layer = ssd_case(*dims, torch.bfloat16, device, gen, iters=4, state=True)
    emit({"phase": "ssd", "at": f"{SSM_ARCH} layer", **layer})
    layer32 = ssd_case(*dims, torch.float32, device, gen, iters=2)
    rows.append(layer32)
    emit({"phase": "ssd", "at": f"{SSM_ARCH} layer, f32", **layer32})
    # zamba2-7b's layer shape (N = 64: the state rows past N and the B/C
    # columns past it are zero fill), the same two ways, from a generator
    # of its own
    zcfg = get_config(HYBRID_ARCH)
    zgen = torch.Generator(device=device).manual_seed(SEED + 22)
    zdims = (HYBRID_BATCH, PROMPT_LEN, zcfg.ssm_heads, zcfg.ssm_head_dim,
             zcfg.ssm_state, zcfg.ssm_chunk)
    zlayer = ssd_case(*zdims, torch.bfloat16, device, zgen, iters=4,
                      state=True)
    emit({"phase": "ssd", "at": f"{HYBRID_ARCH} layer", **zlayer})
    zlayer32 = ssd_case(*zdims, torch.float32, device, zgen, iters=2)
    rows.append(zlayer32)
    emit({"phase": "ssd", "at": f"{HYBRID_ARCH} layer, f32", **zlayer32})
    return {"rows": rows, "layer": layer, "layer_f32": layer32,
            "zamba2_layer": zlayer, "zamba2_layer_f32": zlayer32}


def ssd_layer_checks(cfg, model, prompts, what_path="mamba2") -> dict:
    """One prefill in which every SSD call is also computed exactly
    (:func:`exact_ssd`) on the inputs the main path hands the kernel (each
    layer's real x, dt, A, B, C): each layer's output within the SSD limits
    of the exact y (:func:`ssd_errors`) and the final state from the same
    launch within them of ``ssd_final_state`` and of the exact state
    (:func:`ssd_state_errors`).  Beside them, not gated, the row errors
    against the exact y of the FFMA kernel (on the inputs cast to f32, an
    exact cast, its y rounded to their type), of the plain version in f32
    (the model's plain path: JAX's arithmetic, whose f32 sum of a
    cancelling C_i·B_i loses a few % of a row), and of the exact y rounded
    to the inputs' type (the floor of any output in that type)."""
    import repro_torch.models.layers as model_layers
    from repro_torch.models import prefill
    kernel_scan = model_layers.ssd_scan
    rows = []

    def checked(x, dt, A, Bm, Cm, *, chunk, impl, return_final_state=False):
        y, hk = kernel_scan(x, dt, A, Bm, Cm, chunk=chunk, impl=impl,
                            return_final_state=True)
        ey, eh = exact_ssd(x, dt, A, Bm, Cm, chunk)
        r = ey.float()
        errs = ssd_errors(y.float(), r, x.dtype)
        serr = ssd_state_errors(hk, x, dt, A, Bm, Cm, x.dtype, eh)
        ffma = ssd_ops._launch(x.float(), dt, A, Bm.float(), Cm.float(),
                               chunk, "ffma").to(x.dtype)
        plain = ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)

        def row_err(o):
            return ssd_errors(o.float(), r, x.dtype)["max_row_rel_err"]
        rows.append({**errs, **{k: v for k, v in serr.items()
                                if k != "fault"},
                     "fault": errs["fault"] or serr["fault"],
                     "max_abs_ref": r.abs().max().item(),
                     "ffma_max_row_rel_err": row_err(ffma),
                     "plain_f32_max_row_rel_err": row_err(plain),
                     "rounded_exact_max_row_rel_err": row_err(
                         ey.to(x.dtype))})
        return (y, hk) if return_final_state else y

    model_layers.ssd_scan = checked
    try:
        with torch.inference_mode():
            prefill(cfg, model, {"tokens": prompts}, prompts.shape[1] + 1)
    finally:
        model_layers.ssd_scan = kernel_scan
    faults = [(i, r["fault"]) for i, r in enumerate(rows) if r["fault"]]
    if len(rows) != cfg.n_layers or faults:
        fail(f"{what_path}: {len(rows)} SSD calls in a prefill; layers whose "
             f"kernel output or final state is off the exact result: "
             f"{faults}")
    worst = max(rows, key=lambda r: r["max_row_rel_err"])
    return {"layers_checked": len(rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_abs_ref": max(r["max_abs_ref"] for r in rows),
            "max_row_rel_err": worst["max_row_rel_err"],
            "row_rel_tol": worst["row_rel_tol"],
            "ffma_max_row_rel_err": max(r["ffma_max_row_rel_err"]
                                        for r in rows),
            "plain_f32_max_row_rel_err": max(
                r["plain_f32_max_row_rel_err"] for r in rows),
            "rounded_exact_max_row_rel_err": max(
                r["rounded_exact_max_row_rel_err"] for r in rows),
            # the largest state error over its limit (SSD_TOL·max|h|)
            "state_err_over_limit": max(r["state_max_abs_err"]
                                        / r["state_atol"] for r in rows),
            "state_vs_f64_rel": max(r["state_vs_f64_rel"] for r in rows),
            "final_state_fn_vs_f64_rel": max(r["final_state_fn_vs_f64_rel"]
                                             for r in rows)}


def compare_f32_with_plain(cfg, model, prompts, what_path="mamba2",
                           tol=None) -> dict:
    """The model's weights in f32, through the kernels (f32 routes to the
    FFMA kernels: :func:`launches_per_prefill` of them a prefill, none on
    the tensor cores) and through their plain versions, on the same
    tokens: prefill and first decode logits within ``tol``, or within
    ``0.02·(max|logit| + 1)`` of the plain run's when ``tol`` is None.
    The model's decay erases the carried state within a chunk, so
    last-position logits cannot show a fault in the carried state:
    :func:`ssd_layer_checks` holds every layer's output instead."""
    import dataclasses

    from repro_torch.models import decode_step, prefill
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # the model itself in f32 (a bf16 weight cast to f32 and back is the
    # same weight): zamba2-7b's weights in both types would hold 40 GB
    dtypes = [p.dtype for p in model.parameters()]
    model.float()
    model.cfg = cfg32
    per = launches_per_prefill(cfg)
    kernels = ("flash_attention_wgmma", "flash_attention_ffma",
               "ssd_scan_wgmma", "ssd_scan_ffma")
    logits = {}
    with torch.inference_mode():
        for impl in ("auto", "plain"):
            model.attn_impl = model.ssd_impl = impl
            before = read_launches()
            pre, cache = prefill(cfg32, model, {"tokens": prompts},
                                 prompts.shape[1] + 1)
            after = read_launches()
            routed = {k: after[k] - before[k] for k in kernels}
            want = {k: 0 for k in kernels}
            if impl == "auto":
                want["flash_attention_ffma"] = per["flash_attention"]
                want["ssd_scan_ffma"] = per["ssd_scan"]
            if routed != want:
                fail(f"{what_path} f32 {impl} prefill: launches {routed}, "
                     f"expected {want}")
            tok = logits["auto"][0].argmax(-1) if logits else pre.argmax(-1)
            step, _ = decode_step(cfg32, model, cache, {"token": tok})
            logits[impl] = (pre, step)
            del cache
    for p, dt in zip(model.parameters(), dtypes):
        p.data = p.data.to(dt)
    model.cfg, model.attn_impl, model.ssd_impl = cfg, "auto", "auto"
    checks = {"ffma_launches_per_prefill": {
        k: v for k, v in per.items() if v}}
    for i, what in enumerate(("prefill", "decode_step_1")):
        got, ref = logits["auto"][i], logits["plain"][i]
        if not bool(torch.isfinite(got).all()):
            fail(f"{what_path} f32 {what}: logits not finite")
        diff = (got - ref).abs().max().item()
        bound = tol if tol is not None else \
            0.02 * (ref.abs().max().item() + 1.0)
        checks[what] = {"max_abs_diff_vs_plain": diff, "bound": bound}
        if not diff <= bound:
            fail(f"{what_path} f32 {what}: logits differ from the plain run "
                 f"by {diff} > {bound}")
    return checks


def bf16_rounding_floor(cfg, model, prompts, first_token) -> dict:
    """How far the bf16 model's prefill and first decode logits (the step
    fed ``first_token``) move when only the rounding changes: with the
    plain versions of both kernels, the SSD scan in chunks of
    ``ssm_chunk / 2`` against chunks of ``ssm_chunk`` (the same function,
    summed in another order)."""
    import dataclasses

    from repro_torch.models import decode_step, prefill
    half = dataclasses.replace(cfg, ssm_chunk=cfg.ssm_chunk // 2)
    out = []
    model.attn_impl = model.ssd_impl = "plain"
    with torch.inference_mode():
        for c in (cfg, half):
            model.cfg = c
            pre, cache = prefill(c, model, {"tokens": prompts},
                                 prompts.shape[1] + 1)
            step, _ = decode_step(c, model, cache, {"token": first_token})
            out.append((pre, step))
            del cache
    model.cfg, model.attn_impl, model.ssd_impl = cfg, "auto", "auto"
    return {what: (out[0][i] - out[1][i]).abs().max().item()
            for i, what in enumerate(("prefill", "decode_step_1"))}


def phase_mamba2(device) -> dict:
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import init_params
    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (SSM_BATCH, PROMPT_LEN),
                            generator=gen, device=device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    dense_generate(cfg, model, prompts[:, :256], 2)     # warm: CUDA/cuBLAS
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    run = dense_generate(cfg, model, prompts, GEN)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    # one per layer, all on the tensor-core kernel, none on the FFMA one
    # and no copy; path_profiles shows a lone prefill makes them all
    expected = launches_of(ssd_scan=cfg.n_layers,
                           ssd_scan_wgmma=cfg.n_layers)
    if launches != expected:
        fail(f"mamba2: launches {launches}; expected {expected}")
    floor = bf16_rounding_floor(cfg, model, prompts,
                                run.prefill_logits.argmax(-1))
    out = {"phase": "mamba2", "arch": SSM_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "d_inner": cfg.d_inner,
           "ssd_heads": cfg.ssm_heads, "state": cfg.ssm_state,
           "chunk": cfg.ssm_chunk, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": SSM_BATCH, "prompt_len": PROMPT_LEN, "gen": GEN,
           "launches": launches,
           "prefill_ms": run.prefill_s * 1e3,
           "decode_tok_per_s": SSM_BATCH * GEN / run.decode_s,
           "decode_ms_per_step": run.decode_s * 1e3 / GEN,
           "decode_step_bytes_bound_ms": decode_step_bound_ms(
               cfg, model, SSM_BATCH),
           "max_memory_allocated_gb": peak / 1e9,
           # bf16, held against the model's own rounding floor: see
           # phase 8 of the module docstring
           "bf16_rounding_floor": floor,
           "bf16_vs_plain_ssd": compare_with_plain(
               cfg, model, prompts, run, ("ssd_impl",), "mamba2",
               limits={k: BF16_FLOOR_FACTOR * v for k, v in floor.items()}),
           "f32_vs_plain_ssd": compare_f32_with_plain(
               cfg, model, prompts, tol=MAMBA2_F32_LOGIT_TOL),
           "ssd_per_layer_vs_plain": ssd_layer_checks(cfg, model, prompts),
           "setup_s": setup_s,
           **path_profiles(cfg, model, prompts, "mamba2")}
    emit(out)
    return out


def attention_checks(cfg, model, prompts, what_path) -> dict:
    """One prefill in which every attention call also runs the plain
    version and the exact f64 attention on the inputs the main path hands
    the kernel (each shared-block application's real q, k, v): each within
    the flash phase's gate (:func:`flash_errors`: half a bf16 step plus
    ``GEMMA2_BF16_DELTA`` of the exact attention, each row's error within
    ``ROW_REL_TOL`` of its norm).  Beside it, not gated, the same gate's
    crossings and largest excess of the plain version and of the FFMA
    kernel (on the inputs cast to f32, its output rounded to bf16)."""
    import repro_torch.models.layers as model_layers
    from repro_torch.models import prefill
    kernel_attention = model_layers.attention
    rows = []

    def checked(q, k, v, *, causal, window, softcap, impl):
        o = kernel_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, impl=impl)
        kw = {"causal": causal, "window": window, "softcap": softcap}
        r = attention_ref(q, k, v, **kw)
        ex = exact_attention(q, k, v, rows=512, **kw)
        ffma = flash_ops.attention(q.float(), k.float(), v.float(),
                                   impl="kernel", **kw).to(q.dtype)
        rows.append({**flash_errors(o.float(), r.float(), q.dtype, exact=ex),
                     "max_abs_ref": r.abs().max().item(),
                     "plain": exact_gate(r, ex), "ffma": exact_gate(ffma, ex)})
        return o

    model_layers.attention = checked
    try:
        with torch.inference_mode():
            prefill(cfg, model, {"tokens": prompts}, prompts.shape[1] + 1)
    finally:
        model_layers.attention = kernel_attention
    n = launches_per_prefill(cfg)["flash_attention"]
    faults = [(i, r["fault"]) for i, r in enumerate(rows) if r["fault"]]
    if len(rows) != n or faults:
        fail(f"{what_path}: {len(rows)} attention calls in a prefill "
             f"({n} expected); applications whose kernel output is off the "
             f"exact attention: {faults}")
    return {"applications_checked": len(rows),
            "crossings": sum(r["crossings"] for r in rows),
            "delta": GEMMA2_BF16_DELTA,
            "max_excess_over_half_step": max(r["max_excess_over_half_step"]
                                             for r in rows),
            "max_abs_err_vs_plain": max(r["max_abs_err"] for r in rows),
            "max_abs_ref": max(r["max_abs_ref"] for r in rows),
            "max_row_rel_err": max(r["max_row_rel_err"] for r in rows),
            "row_rel_tol": ROW_REL_TOL[torch.bfloat16],
            **{f"{name}_{k}": agg(r[name][k] for r in rows)
               for name in ("plain", "ffma")
               for k, agg in (("crossings", sum),
                              ("max_excess_over_half_step", max))}}


def phase_zamba2(device) -> dict:
    from repro_torch.launch.serve import dense_generate
    from repro_torch.models import init_params
    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, SEED, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (HYBRID_BATCH, PROMPT_LEN),
                            generator=gen, device=device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    dense_generate(cfg, model, prompts[:, :256], 2)     # warm: CUDA/cuBLAS
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    reset_launches()
    run = dense_generate(cfg, model, prompts, GEN)
    launches = read_launches()
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    # one flash launch per shared-block application and one SSD launch per
    # Mamba2 layer, all on the tensor cores: no FFMA launch, no copy of q, k
    # or v, no cast of dt or A; path_profiles shows a lone prefill makes
    # them all
    per = launches_per_prefill(cfg)
    expected = launches_of(flash_attention=per["flash_attention"],
                           flash_attention_wgmma=per["flash_attention"],
                           ssd_scan=per["ssd_scan"],
                           ssd_scan_wgmma=per["ssd_scan"])
    if launches != expected:
        fail(f"zamba2: launches {launches}; expected {expected}")
    t_checks = time.perf_counter()

    def progress(what: str) -> None:
        """A line after each check: its seconds and the memory in use."""
        emit({"phase": "zamba2", "done": what,
              "s": time.perf_counter() - t_checks,
              "allocated_gb": torch.cuda.memory_allocated(device) / 1e9})

    progress("main path")
    floor = bf16_rounding_floor(cfg, model, prompts,
                                run.prefill_logits.argmax(-1))
    progress("rounding floor")
    checks = {
        "bf16_vs_plain": compare_with_plain(
            cfg, model, prompts, run, ("attn_impl", "ssd_impl"), "zamba2",
            limits={k: BF16_FLOOR_FACTOR * v for k, v in floor.items()})}
    progress("bf16 against the plain versions")
    checks["f32_vs_plain"] = compare_f32_with_plain(cfg, model, prompts,
                                                    "zamba2")
    progress("f32 against the plain versions")
    checks["ssd_per_layer_vs_plain"] = ssd_layer_checks(cfg, model, prompts,
                                                        "zamba2")
    progress("SSD per layer")
    checks["attention_per_application_vs_exact"] = attention_checks(
        cfg, model, prompts, "zamba2")
    progress("attention per application")
    out = {"phase": "zamba2", "arch": HYBRID_ARCH,
           "mamba_layers": cfg.n_layers,
           "shared_block_applications": per["flash_attention"],
           "shared_blocks": cfg.n_shared_blocks, "d_model": cfg.d_model,
           "d_inner": cfg.d_inner, "ssd_heads": cfg.ssm_heads,
           "state": cfg.ssm_state, "chunk": cfg.ssm_chunk,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
           "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": HYBRID_BATCH, "prompt_len": PROMPT_LEN, "gen": GEN,
           "launches": launches,
           "prefill_ms": run.prefill_s * 1e3,
           "decode_tok_per_s": HYBRID_BATCH * GEN / run.decode_s,
           "decode_ms_per_step": run.decode_s * 1e3 / GEN,
           "decode_step_bytes_bound_ms": decode_step_bound_ms(
               cfg, model, HYBRID_BATCH),
           "max_memory_allocated_gb": peak / 1e9,
           # bf16, held against the model's own rounding floor, as mamba2's
           "bf16_rounding_floor": floor, **checks,
           "setup_s": setup_s,
           **path_profiles(cfg, model, prompts, "zamba2")}
    emit(out)
    return out


SSD_CSRC = "src/repro_torch/kernels/ssd_scan/csrc/"


def ssd_entries(ssd: dict, mamba2: dict, zamba2: dict,
                ssm_train: dict) -> list:
    """The kernels line's two SSD scan entries.  The tensor-core kernel
    (bf16, the main paths): one launch at mamba2-130m's layer shape, one
    at zamba2-7b's, and a whole prefill of each; its launches on the
    prefill and train paths.  The FFMA kernel (f32 only, off the main
    paths): one launch at each layer shape in f32."""
    cfg = get_config(SSM_ARCH)
    layer, layer32 = ssd["layer"], ssd["layer_f32"]
    z16, z32 = ssd["zamba2_layer"], ssd["zamba2_layer_f32"]
    rows = {kind: [r for r in ssd["rows"] + [layer, z16]
                   if r["kernel"] == kind] for kind in ("wgmma", "ffma")}
    zshape = (f"B={z16['b']}, S={z16['s']}, H={z16['h']}, P={z16['p']}, "
              f"N={z16['n']}, L={z16['chunk']}")
    zprefill = {"kernel_ms": zamba2["profile_prefill"]["device_ms_by_group"][
                    "ssd_scan"],
                "launches": zamba2["mamba_layers"],
                "bound_ms": zamba2["mamba_layers"] * z16["bound_ms"],
                "prefill_ms": zamba2["prefill_ms"],
                "plain_prefill_ms": zamba2["bf16_vs_plain"][
                    "plain_prefill_ms"]}
    wgmma_paths = by_path("ssd_scan_wgmma", mamba2=mamba2, zamba2=zamba2)
    for run in (ssm_train["mamba2"], ssm_train["zamba2"]):
        wgmma_paths[run["path"]] = run["launches"]["ssd_scan_wgmma"]
    shape = (f"B={SSM_BATCH}, S={PROMPT_LEN}, H={cfg.ssm_heads}, "
             f"P={cfg.ssm_head_dim}, N={cfg.ssm_state}, L={cfg.ssm_chunk}")
    common = {"route": "cuda",
              "replaces": "src/repro/kernels/ssd_scan/kernel.py:73",
              "function": "ssd_scan_pallas", "library_ms": None,
              "library_call": "none: no single PyTorch call computes the "
                              "chunked SSD scan"}
    return [{
        "name": "ssd_scan_wgmma", **common,
        "source": SSD_CSRC + "ssd_scan_wgmma.cu",
        "launches": sum(wgmma_paths.values()),
        "launches_by_path": wgmma_paths,
        "max_abs_err": max(r["max_abs_err"] for r in rows["wgmma"]),
        "ms": layer["kernel_ms"], "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "state_vs_f64_rel": layer["state_vs_f64_rel"],
        "prefill": {
            "kernel_ms": mamba2["profile_prefill"]["device_ms_by_group"][
                "ssd_scan"],
            "bound_ms": cfg.n_layers * layer["bound_ms"],
            "prefill_ms": mamba2["prefill_ms"],
            "plain_prefill_ms": mamba2["bf16_vs_plain_ssd"][
                "plain_prefill_ms"]},
        HYBRID_ARCH: path_entry(
            z16, state_vs_f64_rel=z16["state_vs_f64_rel"], prefill=zprefill,
            at=f"one launch at the layer shape ({zshape}; dt/A f32), final "
               f"state not asked; prefill: the kernel's device time in a "
               f"profiled prefill (each launch with its final state), their "
               f"bound, and the prefill on both kernels and on both plain "
               f"versions"),
        "at": f"bf16, the main path: one launch at the {SSM_ARCH} layer "
              f"shape ({shape}; dt/A f32), final state not asked; "
              f"the bound counts C·B once per batch row and the causal half "
              f"of each chunk; prefill: the kernel's device time in a "
              f"profiled prefill ({cfg.n_layers} launches, each with its "
              f"final state), their bound, and the prefill on the kernel "
              f"and on the plain SSD"}, {
        "name": "ssd_scan", **common,
        "source": SSD_CSRC + "ssd_scan.cu",
        "launches": sum(by_path("ssd_scan_ffma", mamba2=mamba2,
                                zamba2=zamba2).values()),
        "max_abs_err": max(r["max_abs_err"] for r in rows["ffma"]),
        "ms": layer32["kernel_ms"], "plain_ms": layer32["plain_ms"],
        "bound_ms": layer32["bound_ms"], "bound_by": layer32["bound_by"],
        HYBRID_ARCH: path_entry(z32, at=f"f32, {zshape}"),
        "at": f"ssd_scan_kernel, f32 only, off the main path (0 launches "
              f"there): one launch at the {SSM_ARCH} layer shape in f32 "
              f"({shape}), the bound at the f32 FFMA peak"}]


MATMUL_CU = "src/repro_torch/kernels/matmul/csrc/matmul.cu"
MATMUL_WGMMA_CU = "src/repro_torch/kernels/matmul/csrc/matmul_wgmma.cu"
MATMUL_NARROW_CU = "src/repro_torch/kernels/matmul/csrc/matmul_narrow.cu"


def matmul_entries(rows, reduce_rows, skinny, serve, train,
                   oocore, ckpt, mesh) -> list:
    """The kernels line's seven matmul entries.  The skinny kernel and its
    fold at one scorer dispatch at bucket 8 (the serving path: both
    products, read in place as the engine calls them; the fold inside the
    second product's launch).  The tensor-core kernel and its split passes
    at the train path's X·W1, the narrow kernel at its a1·W2 (speech-100k,
    N 10000), with their launches there.  The tile kernel and its split-K
    pass, off both paths, at a1·W2 (their route before the narrow kernel);
    beside the tile kernel, as before, X·W1 and the scorer's two products
    on it.  The out-of-core path's launches (its stream-reduce, stream-out
    and rung-1 runs), the checkpoint path's (its uninterrupted,
    recovered and resumed runs) and the mesh path's (both executors' timed
    steps at world size 1, and at world size 2 summed over the ranks) join
    the tensor-core, split and narrow entries."""
    first, second = serve["products_b8"]
    b = first["m"]
    both = (first, second)
    bnd, by = bound_of(sum(p["bytes_ms"] for p in both),
                       sum(p["operations_ms"] for p in both))
    red = next(r for r in reduce_rows if r["m"] == b)
    folds = [r for r in skinny if r["case"].startswith("fold")]
    shapes = (f"({b}x{first['k']})@({first['k']}x{first['n']}) + "
              f"({b}x{second['k']})@({second['k']}x{second['n']})")
    tp = train["products"]
    tc = next(p for p in tp if p["route"] == "tc")
    narrow = next(p for p in tp if p["route"] == "narrow")
    tshape = f"({narrow['m']}x{narrow['k']})@({narrow['k']}x{narrow['n']})"
    tcshape = f"({tc['m']}x{tc['k']})@({tc['k']}x{tc['n']})"
    sbnd, sby = bound_of(tc["split_bytes_ms"], tc["split_operations_ms"])
    tred = train["splitk_reduce"]
    tgroups = train["profile_step"]["device_ms_by_group"]
    common = {"route": "cuda", "source": MATMUL_CU,
              "replaces": "src/repro/kernels/matmul/kernel.py:39"}
    wgmma = {**common, "source": MATMUL_WGMMA_CU}
    tile_paths = {"scorer": serve["launches"]["matmul"],
                  TRAIN_PATH: train["launches"]["matmul"]}
    ooc, ck = oocore["launches"], ckpt["launches"]

    def on_mesh(key) -> dict:
        return {f"{MESH_PATH}-world1": sum(
                    r["launches"][key] for r in mesh["mesh1"].values()),
                f"{MESH_PATH}-world2": sum(
                    r["launches"][key] for runs in mesh["mesh2"].values()
                    for r in runs)}

    tc_paths = {"scorer": serve["launches"]["matmul_tc"],
                TRAIN_PATH: train["launches"]["matmul_tc"],
                OOC_PATH: ooc["matmul_tc"], CKPT_PATH: ck["matmul_tc"],
                **on_mesh("matmul_tc")}
    split_paths = {"scorer": serve["launches"]["matmul_tf32_split"],
                   TRAIN_PATH: train["launches"]["matmul_tf32_split"],
                   OOC_PATH: ooc["matmul_tf32_split"],
                   CKPT_PATH: ck["matmul_tf32_split"],
                   **on_mesh("matmul_tf32_split")}
    narrow_paths = {"scorer": serve["launches"]["matmul_narrow"],
                    TRAIN_PATH: train["launches"]["matmul_narrow"],
                    OOC_PATH: ooc["matmul_narrow"],
                    CKPT_PATH: ck["matmul_narrow"],
                    **on_mesh("matmul_narrow")}
    reduce_paths = {"scorer": serve["launches"]["matmul_splitk_reduce"],
                    TRAIN_PATH: train["launches"]["matmul_splitk_reduce"]}
    return [{
        "name": "matmul_skinny", **common, "function": "matmul_pallas",
        "launches": serve["launches"]["matmul_skinny"],
        "launches_by_path": {"scorer": serve["launches"]["matmul_skinny"],
                             TRAIN_PATH: train["launches"]["matmul_skinny"]},
        "max_abs_err": max([p["max_abs_err"] for p in both]
                           + [r["max_abs_err"] for r in skinny
                              if not r["case"].startswith("fold")]
                           + [r["max_abs_err"] for r in rows
                              if r["route"] == "skinny"]),
        "ms": sum(p["in_place_device_ms"] for p in both),
        "plain_ms": sum(p["plain_device_ms"] for p in both),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": sum(p["torch_matmul_on_copy_device_ms"] for p in both),
        "library_call": "torch.matmul on each product's copied 2-D operands",
        "events_ms": sum(p["in_place_ms"] for p in both),
        "library_events_ms": sum(p["torch_matmul_on_copy_ms"] for p in both),
        "first_product_ms": first["in_place_device_ms"],
        "first_product_library_ms": first["torch_matmul_on_copy_device_ms"],
        "first_product_bound_ms": first["bound_ms"],
        "at": f"one scorer dispatch at bucket {b}, f32: {shapes}, each "
              f"product read in place as the engine calls it (W1 as the "
              f"blocked view {first['b_view']['shape']}); the second's time "
              f"includes its fold; ms, plain_ms, library_ms: device time "
              f"(torch.profiler); *events_ms: CUDA events over back-to-back "
              f"calls, host work included"}, {
        "name": "matmul_skinny_fold", **common,
        "function": "matmul_pallas (its f32 accumulation over the K grid)",
        "launches": serve["launches"]["matmul_fold"],
        "max_abs_err": max(r["max_abs_err"] for r in folds),
        "ms": second["in_place_device_ms"],
        "plain_ms": second["plain_device_ms"],
        "bound_ms": second["bound_ms"], "bound_by": second["bound_by"],
        "library_ms": second["torch_matmul_on_copy_device_ms"],
        "library_call": "torch.matmul on the copied 2-D operands",
        "events_ms": second["in_place_ms"],
        "library_events_ms": second["torch_matmul_on_copy_ms"],
        "at": f"the fold runs inside matmul_skinny's launch for "
              f"({b}x{second['k']})@({second['k']}x{second['n']}): ms is "
              f"that whole launch's device time, fold included; "
              f"max_abs_err is the fold against splitk_reduce_ref of its "
              f"own partial tiles"}, {
        "name": "matmul_tc", **wgmma, "function": "matmul_pallas",
        "launches": sum(tc_paths.values()), "launches_by_path": tc_paths,
        "max_abs_err": max([r["max_abs_err"] for r in rows
                            if r["route"] == "tc"] + [tc["max_abs_err"]]),
        "ms": tc["tc_kernel_ms"], "plain_ms": tc["plain_ms"],
        "bound_ms": tc["bound_ms"], "bound_by": tc["bound_by"],
        "library_ms": tc["library_ms"],
        "library_call": "torch.matmul (TF32 off)",
        "ffma_bound_ms": tc["ffma_operations_ms"],
        "route_ms": tc["kernel_ms"], "in_place_ms": tc["in_place_ms"],
        "tile_kernel_ms": tc["tile_ms"],
        "kernel_ms_in_profiled_step": tgroups["matmul_tc"],
        "at": f"matmul_tc_kernel alone on the split operands of the train "
              f"path's X·W1 {tcshape}, CUDA events over back-to-back calls; "
              f"bound: three TF32 products at the tensor cores' rate "
              f"(ffma_bound_ms: one f32 product at the FFMA rate); "
              f"route_ms: the two split passes and the kernel on 2-D "
              f"operands, in_place_ms: as the engine calls the op; "
              f"tile_kernel_ms: the same product on matmul_tile_kernel, "
              f"X·W1's route before"}, {
        "name": "matmul_tf32_split", **wgmma,
        "function": "matmul_pallas (its f32 operands, read as two TF32 "
                    "terms each)",
        "launches": sum(split_paths.values()),
        "launches_by_path": split_paths,
        "max_abs_err": tc["split_max_abs_err"],
        "ms": tc["split_passes_ms"], "plain_ms": tc["split_plain_ms"],
        "bound_ms": sbnd, "bound_by": sby, "library_ms": None,
        "library_call": None,
        "kernel_ms_in_profiled_step": tgroups["tf32_split"],
        "at": f"both split passes of the train path's X·W1 {tcshape} (X, "
              f"and W1 transposed), CUDA events; max_abs_err against "
              f"tf32_split_ref (torch bit operations); no PyTorch call "
              f"computes it"}, {
        "name": "matmul_narrow", **common, "source": MATMUL_NARROW_CU,
        "function": "matmul_pallas",
        "launches": sum(narrow_paths.values()),
        "launches_by_path": narrow_paths,
        "folding_launches_by_path": {
            "scorer": serve["launches"]["matmul_narrow_fold"],
            TRAIN_PATH: train["launches"]["matmul_narrow_fold"],
            OOC_PATH: ooc["matmul_narrow_fold"],
            CKPT_PATH: ck["matmul_narrow_fold"],
            **on_mesh("matmul_narrow_fold")},
        "max_abs_err": narrow["max_abs_err"],
        "ms": narrow["kernel_ms"], "plain_ms": narrow["plain_ms"],
        "bound_ms": narrow["bound_ms"], "bound_by": narrow["bound_by"],
        "library_ms": narrow["library_ms"],
        "library_call": "torch.matmul",
        "in_place_ms": narrow["in_place_ms"],
        "tile_kernel_ms": narrow["tile_ms"],
        "kernel_ms_in_profiled_step": tgroups["matmul_narrow"],
        "splits": narrow["narrow_splits"], "stages": narrow["narrow_stages"],
        "at": f"matmul_narrow_kernel at the train path's a1·W2 {tshape} on "
              f"2-D contiguous operands, CUDA events over back-to-back "
              f"calls, its split-K fold included; in_place_ms: as the "
              f"engine calls the op (a1 and W2 read in place); "
              f"tile_kernel_ms: the same product on matmul_tile_kernel and "
              f"its split-K pass, a1·W2's route before; max_abs_err "
              f"against the plain version in f32"}, {
        "name": "matmul", **common, "function": "matmul_pallas",
        "launches": sum(tile_paths.values()),
        "launches_by_path": tile_paths,
        "max_abs_err": max([r.get("tile_max_abs_err", r["max_abs_err"])
                            for r in rows]
                           + [p["tile_max_abs_err"] for p in tp]),
        "ms": narrow["tile_ms"], "plain_ms": narrow["plain_ms"],
        "bound_ms": narrow["bound_ms"], "bound_by": narrow["bound_by"],
        "library_ms": narrow["library_ms"],
        "library_call": "torch.matmul",
        TRAIN_PATH: {
            "products": [{key: p[key] for key in (
                "m", "k", "n", "route", "tile_splits", "kernel_ms",
                "in_place_ms", "tile_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "ffma_operations_ms")}
                for p in tp],
            "kernel_ms_in_profiled_step": tgroups["matmul_tile"],
            "step_ms_median": train["step_ms_median_2_to_5"],
            "copies_per_step": train["matmul_copies_per_step"]},
        "x_w1_on_tile_kernel": {
            "ms": tc["tile_ms"], "bound_ms": tc["ffma_operations_ms"],
            "bound_by": "operations", "plain_ms": tc["plain_ms"],
            "library_ms": tc["library_ms"],
            "at": f"{tcshape} on matmul_tile_kernel (FFMA), off the main "
                  f"path since the tensor-core route took it"},
        "scorer_products_on_copies": {
            "ms": sum(p["tile_kernel_on_copy_device_ms"] for p in both),
            "plain_ms": sum(p["plain_device_ms"] for p in both),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": sum(p["torch_matmul_on_copy_device_ms"]
                              for p in both),
            "events_ms": sum(p["tile_kernel_on_copy_ms"] for p in both),
            "at": f"the scorer dispatch's products {shapes} on the copied "
                  f"2-D operands (off the serving path); device times"},
        "at": f"matmul_tile_kernel (bf16 only since the narrow kernel; off "
              f"both paths): the train path's a1·W2 {tshape} on 2-D "
              f"contiguous operands, CUDA events over back-to-back calls, "
              f"its split-K pass included, the route a1·W2 took before"}, {
        "name": "matmul_splitk_reduce", **common,
        "function": "matmul_pallas (its f32 accumulation over the K grid)",
        "launches": sum(reduce_paths.values()),
        "launches_by_path": reduce_paths,
        "max_abs_err": max(r["max_abs_err"] for r in reduce_rows + [tred]),
        "ms": tred["kernel_ms"], "plain_ms": tred["plain_ms"],
        "bound_ms": tred["bound_ms"], "bound_by": tred["bound_by"],
        "library_ms": tred["library_ms"], "library_call": "sum(0)",
        "kernel_ms_in_profiled_step": tgroups["splitk_reduce"],
        "scorer": {key: red[key] for key in (
            "splits", "m", "n", "of_product_k", "kernel_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")},
        "at": f"the tile kernel's split-K pass (off both paths since the "
              f"narrow kernel folds a1·W2's sum): the {tred['splits']} "
              f"partial sums of ({tred['m']}x{tred['of_product_k']})@("
              f"{tred['of_product_k']}x{tred['n']}); scorer: at the "
              f"scorer's second product"}]


# ------------------------------------------------------------ LM decode
LM_CAPACITY = 8
LM_REQUESTS = 40
LM_RATE = 50.0                   # requests/s, Poisson
LM_PROMPT = (1, 8)               # prompt tokens (lm_mix's defaults)
LM_NEW = (1, 12)                 # new tokens
LM_MAX_RETRIES = 8               # benchmarks/resilience.py's MAX_RETRIES
LM_CHAOS = {"site_every": 7, "nan_node": "relu", "nan_every": 11}
LM_PROFILE_TICKS = 10


def lm_logit_limit(lm, h, wo_max: float) -> tuple:
    """(rtol, atol) for one step's logits ``h'·Wo``: ``tolerance(d, f32)``,
    whose atol 1e-5·√K assumes operands of unit size, with its atol scaled
    by max|h'|·max|Wo| (Wo is drawn at d^-0.5, a logit is ~1e-2).  Never
    above the ceiling: it tightens the limit so that it parts f32 from a
    TF32 product (:func:`lm_precision_control`)."""
    rtol, atol = tolerance(lm.d, torch.float32)
    return rtol, min(atol, atol * float(h.abs().max()) * wo_max)


def lm_oracle(lm, prompt, max_new_tokens, wo_max: float) -> tuple:
    """``oracle_decode``'s loop, step by step through ``oracle_step``, on
    the card in plain f32: the generated tokens, their logits, and each
    step's :func:`lm_logit_limit`."""
    h = torch.zeros((1, lm.d), dtype=torch.float32, device=lm.device)
    for t in prompt[:-1]:
        h, _ = lm.oracle_step(h, int(t))
    tok, toks, logs, limits = int(prompt[-1]), [], [], []
    for _ in range(max_new_tokens):
        h, logits = lm.oracle_step(h, tok)
        tok = lm.next_token(logits)
        toks.append(tok)
        logs.append(logits)
        limits.append(lm_logit_limit(lm, h, wo_max))
    return toks, logs, limits


def lm_wo_max(lm) -> float:
    return float(lm.weights()["lm.Wo"].data.abs().max())


def lm_token_checks(lm, reqs, results) -> dict:
    """Each request's tokens against the oracle's (:func:`lm_oracle`), each
    generated token's logits within that step's :func:`lm_logit_limit` of
    the oracle's.  Where the tokens part, the oracle's two highest logits
    at that step must lie within the same limit of each other (a tie on
    rounding alone at 256000 logits); such a case is counted, and the
    steps after it, conditioned on other tokens, are not compared.  The
    worst share is read against the ceiling ``tolerance(d, f32)`` too."""
    rtol, ceiling = tolerance(lm.d, torch.float32)
    wo_max = lm_wo_max(lm)
    worst, worst_ceiling, compared, ties = 0.0, 0.0, 0, []
    atols = []
    for r, (req, res) in enumerate(zip(reqs, results)):
        toks, logs, limits = lm_oracle(lm, req.prompt, req.max_new_tokens,
                                       wo_max)
        if len(res["tokens"]) != len(toks) or \
                len(res["logits"]) != len(logs):
            fail(f"lm_serve: request {r} gave {len(res['tokens'])} tokens, "
                 f"the oracle {len(toks)}")
        for j, (gt, wt, gl, wl, (_, atol)) in enumerate(zip(
                res["tokens"], toks, res["logits"], logs, limits)):
            gl, wl = np.asarray(gl), np.asarray(wl)
            if gl.shape != (lm.vocab,) or not np.all(np.isfinite(gl)):
                fail(f"lm_serve: request {r} step {j}: logits of shape "
                     f"{gl.shape} / not finite")
            off = np.abs(gl - wl)
            share = float(np.max(off / (atol + rtol * np.abs(wl))))
            worst = max(worst, share)
            worst_ceiling = max(worst_ceiling, float(np.max(
                off / (ceiling + rtol * np.abs(wl)))))
            atols.append(atol)
            compared += 1
            if share > 1.0:
                fail(f"lm_serve: request {r} step {j}: logits off the "
                     f"oracle's by {share:.3f}x the step's limit "
                     f"(atol {atol})")
            if gt != wt:
                top = np.sort(wl)[-2:]
                limit = atol + rtol * abs(float(top[1]))
                gap = float(top[1] - top[0])
                if gap > limit:
                    fail(f"lm_serve: request {r} step {j}: token {gt} "
                         f"against the oracle's {wt}, whose top-2 gap "
                         f"{gap} exceeds the limit {limit}")
                ties.append({"request": r, "step": j, "token": gt,
                             "oracle_token": wt, "top2_gap": gap,
                             "limit": limit})
                break
    return {"logits_compared": compared,
            "logits_worst_share_of_limit": worst,
            "logits_worst_share_of_ceiling": worst_ceiling,
            "near_ties": len(ties), "near_tie_cases": ties,
            "tolerance": [rtol, ceiling],
            "step_atol_range": [min(atols), max(atols)]}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest): the operands a
    tensor-core f32 product reads when ``allow_tf32`` is on."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def lm_precision_control(lm, compiled) -> dict:
    """The control on the logits gate.  One full tick of the served step
    program from a non-zero state, against the f32 oracle's step for every
    slot: as served it must pass :func:`lm_logit_limit`; the same tick's
    logits from operands at TF32 and at bf16 precision (the oracle's h'
    and Wo rounded, products summed in f32) must fail it.  Also read: the
    served tick with ``allow_tf32`` on (cuBLAS may or may not take tensor
    cores for the step's products), and every share of the ceiling
    ``tolerance(d, f32)``."""
    c, d = lm.capacity, lm.d
    weights, wo_max = lm.weights(), lm_wo_max(lm)
    wo = weights["lm.Wo"].data[0, 0]
    rtol, ceiling = tolerance(d, torch.float32)
    s0 = compiled.run(**lm.step_inputs(list(range(1, c + 1))), **weights,
                      **{"lm.state": lm.init_state()})["state"]
    toks = list(range(c + 1, 2 * c + 1))
    rows = s0.data.reshape(c, d)
    hs, want, atols = [], [], []
    for i, t in enumerate(toks):
        h, logits = lm.oracle_step(rows[i:i + 1], t)
        hs.append(h)
        want.append(logits)
        atols.append(lm_logit_limit(lm, h, wo_max)[1])
    h = torch.cat(hs)

    def served(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            got = compiled.run(**lm.step_inputs(toks), **weights,
                               **{"lm.state": s0})["logits"].data
            return got.reshape(c, lm.vocab).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def shares(got):
        off = [np.abs(g - w) for g, w in zip(got, want)]
        return {"worst_share_of_limit": max(float(np.max(
                    o / (a + rtol * np.abs(w)))) for o, a, w in
                    zip(off, atols, want)),
                "worst_share_of_ceiling": max(float(np.max(
                    o / (ceiling + rtol * np.abs(w)))) for o, w in
                    zip(off, want)),
                "max_abs_err": max(float(o.max()) for o in off)}

    out = {"served_f32": shares(served(False)),
           "served_allow_tf32": shares(served(True)),
           "tf32_operands": shares(
               (tf32_round(h) @ tf32_round(wo)).cpu().numpy()),
           "bf16_operands": shares(
               (h.bfloat16().float() @ wo.bfloat16().float()).cpu().numpy())}
    if out["served_f32"]["worst_share_of_limit"] > 1.0:
        fail(f"lm_serve control: the served tick fails its limit ({out})")
    for name in ("tf32_operands", "bf16_operands"):
        if out[name]["worst_share_of_limit"] <= 1.0:
            fail(f"lm_serve control: logits from {name} pass the limit, "
                 f"which then cannot tell them from f32 ({out})")
    return out


def lm_tick_bound_ms(lm) -> tuple:
    """The least time of one decode tick: its three products (s·Wh and
    emb·Wx at capacity rows, h·Wo), each operand read once and each output
    written once, by :func:`bound_times`; Wh, Wx and Wo hold (2·d² +
    d·vocab)·4 bytes."""
    c, d, v = lm.capacity, lm.d, lm.vocab
    parts = [bound_times(c, d, d, torch.float32),
             bound_times(c, d, d, torch.float32),
             bound_times(c, d, v, torch.float32)]
    t_bytes = sum(p[0] for p in parts)
    t_ops = sum(p[1] for p in parts)
    return (*bound_of(t_bytes, t_ops), t_bytes, t_ops,
            (2 * d * d + d * v) * 4)


def timed_ticks(server) -> list:
    """Wrap the server's decode tick: host-clock ms of every tick that
    dispatched (ending in the logits' copy to the host, which syncs)."""
    ms, real = [], server._step_decode

    def tick(now):
        before = sum(server.dispatches.values())
        t0 = time.perf_counter()
        out = real(now)
        if sum(server.dispatches.values()) > before:
            ms.append((time.perf_counter() - t0) * 1e3)
        return out

    server._step_decode = tick
    return ms


def lm_serve_run(lm, engine, reqs, arrivals, **kw):
    from repro_torch.serve import TraServer, open_loop
    server = TraServer(engine, lm, collect_logits=True, **kw)
    server.warmup()
    ticks = timed_ticks(server)
    reset_launches()
    report = open_loop(server, reqs, arrivals)
    launches = read_launches()
    return server, report, launches, ticks


def phase_lm_serve(device, smi) -> dict:
    """``RecurrentLM`` at gemma2-2b's full width served through
    ``TraServer`` on the ``jit`` executor: 40 Poisson requests, then the
    same requests under a chaos schedule with ``check_numerics``."""
    from repro_torch.core import Engine
    from repro_torch.serve import (RecurrentLM, chaos_injector, lm_mix,
                                   poisson_arrivals)
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = RecurrentLM.from_config(cfg, capacity=LM_CAPACITY, seed=SEED,
                                 device=device)
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    reqs = lm_mix(lm, rng, LM_REQUESTS, prompt_len=LM_PROMPT,
                  new_tokens=LM_NEW)
    arrivals = poisson_arrivals(rng, LM_REQUESTS, LM_RATE)
    engine = Engine(executor="jit", device=device)
    torch.cuda.reset_peak_memory_stats(device)

    # -- the main path: every launch count is 0 just before, read just after
    server, report, launches, ticks = lm_serve_run(lm, engine, reqs,
                                                   arrivals)
    # ---------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated(device)
    if report.errors or report.shed:
        fail(f"lm_serve: {report.errors} errors, {report.shed} shed")
    if engine.cache_misses != 1 or server.cache_misses_since_warmup != 0:
        fail(f"lm_serve: {engine.cache_misses} compiles, "
             f"{server.cache_misses_since_warmup} cache misses after "
             f"warmup; expected 1 and 0")
    # JAX's unfused plan: the products are cuBLAS calls, no hand kernel
    if launches != launches_of():
        fail(f"lm_serve: launches {launches}; expected none")
    if any(s is not None for s in server._slots) or \
            bool(server._state.data.abs().max() != 0):
        fail("lm_serve: the drained server holds a slot or a non-zero "
             "state row")
    checks = lm_token_checks(lm, reqs, report.results)
    # the one compile (and its verification) is warmup's, before the
    # timed ticks: cache_misses_since_warmup is 0 above
    lm_verify_ms = verify_ms(engine, lm.step_program(), "lm_serve")

    # -- the chaos run: same requests, periodic faults, numeric guards
    inj = chaos_injector(**LM_CHAOS)
    chaos_engine = Engine(executor="jit", device=device, fault_injector=inj,
                          check_numerics=True)
    chaos, chaos_report, chaos_launches, _ = lm_serve_run(
        lm, chaos_engine, reqs, arrivals, max_retries=LM_MAX_RETRIES)
    if chaos_report.errors or chaos_report.shed:
        fail(f"lm_serve chaos: {chaos_report.errors} errors, "
             f"{chaos_report.shed} shed")
    for r, (a, b) in enumerate(zip(report.results, chaos_report.results)):
        if a["tokens"] != b["tokens"]:
            fail(f"lm_serve chaos: request {r} tokens {b['tokens']} differ "
                 f"from the clean run's {a['tokens']}")
    counters = chaos.counters
    if counters["transient_faults"] == 0 or counters["recovered"] == 0:
        fail(f"lm_serve chaos: no fault was retried and recovered "
             f"({counters})")
    if chaos_launches != launches_of():
        fail(f"lm_serve chaos: launches {chaos_launches}; expected none")

    # -- what a tick costs: device time by kernel, the two host syncs
    compiled = engine.compile(lm.step_program())
    full = lm.step_inputs(list(range(1, LM_CAPACITY + 1)))
    state = lm.init_state()

    def tick():
        outs = compiled.run(**full, **lm.weights(), **{"lm.state": state})
        outs["logits"].data.cpu()
        lm.snapshot_state(outs["state"])

    def ticks_fn():
        for _ in range(LM_PROFILE_TICKS):
            tick()

    tick()
    prof = device_profile(ticks_fn, groups=(("gemm", GEMM_NAMES),))
    outs = compiled.run(**full, **lm.weights(), **{"lm.state": state})
    logits, new_state = outs["logits"].data, outs["state"]
    control = lm_precision_control(lm, compiled)
    bound, by, t_bytes, t_ops, weight_bytes = lm_tick_bound_ms(lm)
    summary = report.summary
    out = {"phase": "lm_serve", "card": smi, "arch": ARCH,
           "d_model": lm.d, "vocab": lm.vocab, "capacity": lm.capacity,
           "requests": report.requests, "arrival_rate_per_s": LM_RATE,
           "prompt_len": list(LM_PROMPT), "new_tokens": list(LM_NEW),
           "ticks": sum(server.dispatches.values()),
           "tick_ms_median": float(np.median(ticks)),
           "tick_ms_p90": float(np.percentile(ticks, 90)),
           "tick_device_ms": prof["device_ms_total"] / LM_PROFILE_TICKS,
           "tick_profile": prof,
           "tick_bound_ms": bound, "tick_bound_by": by,
           "tick_bytes_ms": t_bytes, "tick_operations_ms": t_ops,
           "weight_bytes": weight_bytes,
           "logits_to_host_bytes": logits.numel() * logits.element_size(),
           "logits_to_host_ms": timed_ms(lambda: logits.cpu(), device, 20),
           "state_snapshot_ms": timed_ms(
               lambda: lm.snapshot_state(new_state), device, 20),
           "tokens_per_s": summary["tokens_per_s"],
           "tokens": summary["tokens"], "wall_s": report.wall_s,
           "p50_ms": summary["total_ms"]["p50"],
           "p99_ms": summary["total_ms"]["p99"],
           "queue_wait_p50_ms": summary["queue_wait_ms"]["p50"],
           "launches": launches,
           "validate": engine.validate,
           "diagnostics": diag_counts(engine),
           "compiles": engine.cache_misses,
           "cache_misses_since_warmup": server.cache_misses_since_warmup,
           "verify_ms": lm_verify_ms,
           "verify_ms_median": sorted(lm_verify_ms)[2],
           "max_memory_allocated_gb": peak / 1e9,
           **checks,
           "precision_control": control,
           "chaos": {"schedule": LM_CHAOS, "max_retries": LM_MAX_RETRIES,
                     "counters": dict(counters),
                     "faults_fired": {k: sum(1 for kind, _ in inj.log
                                             if kind == k)
                                      for k in ("site", "nan")},
                     "ticks": sum(chaos.dispatches.values()),
                     "wall_s": chaos_report.wall_s,
                     "extra_wall_s": chaos_report.wall_s - report.wall_s,
                     "p99_ms": chaos_report.summary["total_ms"]["p99"]},
           "setup_s": setup_s}
    emit(out)
    return out

# ------------------------------------------------------------- lm_train
LM_TRAIN_ARCH = "gemma2-2b"
LM_TRAIN_STEPS = 6
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128    # launch/train.py's defaults
LM_TRAIN_PATH = "gemma2-2b-train-8x128"
# Step 1 of the kernel run against the same step with the plain attention
# (same weights, same batch): the loss within LM_TRAIN_LOSS_RTOL of it and
# the gradient's global norm within LM_TRAIN_GNORM_RTOL.  Set before the
# first card run: the two attentions agree to an f32 rounding before their
# bf16 outputs and gradients are rounded, so a step-1 loss (a mean over
# 1024 tokens of ~12.5 nats) moves by far less than 1e-3 of itself, and the
# norm over 2.6 B bf16 gradients by far less than 1e-2.
LM_TRAIN_LOSS_RTOL = 1e-3
LM_TRAIN_GNORM_RTOL = 1e-2
# The card restart (tests/test_runtime.py::test_restart_reproduces_
# uninterrupted_run at the qwen2.5-14b smoke width): checkpoints every 2
# steps, a SimulatedFailure at step 3, 6 steps, held bit for bit.
RESTART_ARCH = "qwen2.5-14b"
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 6, 2, 3
LM_TRAIN_GROUPS = (("flash_backward", ("flash_attention_bwd",)),
                   ("flash_forward", ("flash_attention_kernel",)),
                   ("gemm", GEMM_NAMES),
                   ("elementwise_and_adamw", ("elementwise", "reduce",
                                              "foreach", "index", "gather",
                                              "scatter", "cat", "copy",
                                              "softmax", "norm", "fill")))


def bwd_bound_times(b, hq, hkv, sq, skv, d, dv, dtype, causal,
                    window) -> dict:
    """(bytes_ms, operations_ms) of each backward kernel on an H100 SXM.
    dq: q, k, v, dO read once, dq and the f32 row statistics (LSE, D)
    written once, against 2·(2d + dv) operations an unmasked pair (S = QKᵀ,
    dP = dO·Vᵀ, dQ = dS·K).  dkdv: q, k, v, dO and the statistics read once,
    dk and dv written once, against 2·(2d + 2dv) an unmasked pair (S, dP,
    dV = Pᵀ·dO, dK = dSᵀ·Q).  The pass that computes LSE and D is the
    kernel's choice, not work the function needs: not counted."""
    isz = torch.tensor([], dtype=dtype).element_size()
    q_el, kv_el = b * hq * sq, b * hkv * skv
    stats = 2 * q_el * 4
    pairs = b * hq * attention_pairs(sq, skv, causal, window)
    dq_bytes = (q_el * (2 * d + dv) + kv_el * (d + dv)) * isz + stats
    dkdv_bytes = (q_el * (d + dv) + 2 * kv_el * (d + dv)) * isz + stats
    return {"dq": (dq_bytes / H100_SXM.hbm_bw * 1e3,
                   2.0 * (2 * d + dv) * pairs / PEAK[dtype] * 1e3),
            "dkdv": (dkdv_bytes / H100_SXM.hbm_bw * 1e3,
                     2.0 * (2 * d + 2 * dv) * pairs / PEAK[dtype] * 1e3)}


def bwd_kernel_ms(q, k, v, do, kw, device, iters: int = 20) -> dict:
    """Device ms of one launch of each backward kernel alone: CUDA events
    around ``iters`` back-to-back launches through its C entry point (the
    routed dQ kernel first, so the dk/dv kernel reads its statistics; where
    that is the tensor-core kernel, ``dq_ffma`` times the FFMA dQ kernel
    beside it); these launches are not counted."""
    routed = flash_ops.bwd_route(q, k, v)
    _, call = flash_ops._bwd_call(q, k, v, do, kw["causal"], kw["window"],
                                  kw["softcap"], q.shape[3] ** -0.5, routed)
    lib = flash_ops._lib()
    kernels = [("dq", getattr(lib, call.dq_entry), call.dq_args),
               ("dkdv", lib.repro_flash_attention_bwd_dkdv, call.dkdv_args)]
    if routed == "tc":
        kernels.append(("dq_ffma", lib.repro_flash_attention_bwd_dq,
                        call.dkdv_args))
    out = {}
    for which, fn, args in kernels:
        def launch(fn=fn, which=which, args=args):
            rc = fn(*args)
            if rc != 0:
                fail(f"backward {which} kernel: launch error {rc}")
        out[which] = timed_ms(launch, device, iters)
    return out


def bwd_stats_errors(q, k, v, do, kw, routed: str) -> dict:
    """One uncounted launch of the ``routed`` dQ kernel: its row statistics
    (LSE, D) against ``attention_bwd_stats_ref`` on the same inputs, each
    within :func:`flash_errors`' f32 limits (``FLASH_TOL`` elementwise,
    ``ROW_REL_TOL`` along Sq), and LSE +inf exactly where a row has no
    unmasked key.  ``fault`` says what failed, or is None."""
    _, call = flash_ops._bwd_call(q, k, v, do, kw["causal"], kw["window"],
                                  kw["softcap"], q.shape[3] ** -0.5, routed)
    rc = getattr(flash_ops._lib(), call.dq_entry)(*call.dq_args)
    if rc != 0:
        fail(f"backward dq {routed} kernel: launch error {rc}")
    lse, delta = call.keep[:2]
    want_lse, want_delta = attention_bwd_stats_ref(q, k, v, do, **kw)
    seen = torch.isfinite(want_lse)
    out = {name: flash_errors(g, w, torch.float32) for name, g, w in (
        ("lse", lse.where(seen, 0.0), want_lse.where(seen, 0.0)),
        ("delta", delta, want_delta))}
    out["fault"] = next((f"{name}: {out[name]['fault']}" for name in
                         ("lse", "delta") if out[name]["fault"]), None)
    if not bool((lse[~seen] == float("inf")).all()):
        out["fault"] = "lse: a row with no unmasked key is not +inf"
    return out


def sdpa_backward_ms(q, k, v, do, device) -> float:
    """Device ms of one backward of ``scaled_dot_product_attention`` (causal,
    no window, no soft-cap: the nearest function one PyTorch call computes)
    at these shapes; the yardstick, used nowhere in the port."""
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=q.shape[1] != k.shape[1])
    return timed_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                retain_graph=True),
                    device, 10)


def bwd_case(b, hq, hkv, sq, skv, d, dv, dtype, kw, device, gen,
             timed=False) -> dict:
    """The backward kernels against ``attention_bwd_ref`` (autograd
    through the plain attention) on one input and output gradient: dq, dk
    and dv each within :func:`flash_errors`' limits (the forward's:
    elementwise ``FLASH_TOL``, each row within ``ROW_REL_TOL`` of its
    norm, but the dq rows of queries that see one key); one launch of the
    dQ kernel :func:`flash_ops.bwd_route` names (and none of the other)
    and of the dK/dV kernel; the dQ kernel's statistics
    (:func:`bwd_stats_errors`); the tensor-core dQ kernel's dq within
    ``BWD_TC_DQ_SHARE`` of each limit.  ``timed``: each kernel's device ms
    (:func:`bwd_kernel_ms`),
    the plain backward's ms, the bounds, and SDPA's backward at the same
    shapes without soft-cap or window."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, dv)
    do = rnd(b, hq, sq, dv)
    routed = flash_ops.bwd_route(q, k, v)

    def counts():
        return (flash_ops.BWD_DQ_LAUNCHES, flash_ops.BWD_DQ_TC_LAUNCHES,
                flash_ops.BWD_DQ_FFMA_LAUNCHES, flash_ops.BWD_DKDV_LAUNCHES)
    before = counts()
    got = flash_ops.attention_bwd(q, k, v, do, impl="kernel", **kw)
    launched = tuple(a - c for a, c in zip(counts(), before))
    want = attention_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize(device)
    name = (f"attention backward b{b} h{hq}/{hkv} s{sq}/{skv} d{d}/{dv} "
            f"{dtype} {kw}")
    expect = (1, int(routed == "tc"), int(routed == "ffma"), 1)
    if launched != expect:
        fail(f"{name}: (dq, dq tc, dq ffma, dkdv) launches {launched}, "
             f"expected {expect} (dq route {routed})")
    row = {"b": b, "hq": hq, "hkv": hkv, "sq": sq, "skv": skv, "d": d,
           "dv": dv, "dtype": str(dtype).split(".")[-1], **kw,
           "dq_route": routed}
    # a query that sees one key has dq = 0 exactly (a softmax over one
    # element has no derivative): both sides hold rounding noise there, so
    # those rows are held elementwise only
    seen = visible_keys(sq, skv, kw["causal"], kw["window"])
    for which, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != dtype:
            fail(f"{name}: {which} {tuple(g.shape)} {g.dtype}")
        errs = flash_errors(g.float(), w.float(), dtype,
                            rows=torch.from_numpy(seen > 1).to(device)
                            if which == "dq" else None)
        fault = errs.pop("fault")
        if fault is not None:
            fail(f"{name}: {which}: {fault}")
        row[which] = {**errs, "max_abs_ref": w.float().abs().max().item()}
        if which == "dq" and routed == "tc":
            tol = FLASH_TOL[dtype]
            shares = {"elementwise": ((g.float() - w.float()).abs() / (
                tol + tol * w.float().abs())).max().item(),
                "row": errs["max_row_rel_err"] / ROW_REL_TOL[dtype]}
            row[which]["share_of_limit"] = shares
            if max(shares.values()) > BWD_TC_DQ_SHARE:
                fail(f"{name}: dq tc kernel takes {shares} of its limits, "
                     f"over {BWD_TC_DQ_SHARE}: its dS terms are too few")
    row["max_abs_err"] = max(row[w]["max_abs_err"] for w in ("dq", "dk",
                                                             "dv"))
    del got, want
    row["stats"] = bwd_stats_errors(q, k, v, do, kw, routed)
    if row["stats"]["fault"] is not None:
        fail(f"{name}: dq {routed} kernel's statistics: "
             f"{row['stats']['fault']}")
    if timed:
        bounds = bwd_bound_times(b, hq, hkv, sq, skv, d, dv, dtype,
                                 kw["causal"], kw["window"])
        row["kernel_ms"] = bwd_kernel_ms(q, k, v, do, kw, device)
        row["bound_ms"], row["bound_by"] = {}, {}
        for which, (t_bytes, t_ops) in bounds.items():
            row["bound_ms"][which], row["bound_by"][which] = bound_of(
                t_bytes, t_ops)
        row["both_kernels_ms"] = timed_ms(lambda: flash_ops.attention_bwd(
            q, k, v, do, impl="kernel", **kw), device, 10)
        row["plain_ms"] = timed_ms(lambda: attention_bwd_ref(
            q, k, v, do, **kw), device, 5)
        row["library_ms"] = sdpa_backward_ms(q, k, v, do, device)
        row["library_call"] = ("torch.autograd.grad of F.scaled_dot_product_"
                               "attention(is_causal=True) (no soft-cap, no "
                               "window)")
    return row


def lm_train_bwd_cases(cfg, device, gen) -> dict:
    """The backward kernels at gemma2-2b's train shapes (both layer kinds),
    a longer gemma2-head case, a ragged S, GQA 4:1 and f32."""
    hq, hkv, hd, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.attn_softcap
    B, S = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    win = {"causal": True, "window": cfg.attn_window, "softcap": cap}
    glob = {"causal": True, "window": 0, "softcap": cap}
    bf, f32 = torch.bfloat16, torch.float32
    layers = {"window": bwd_case(B, hq, hkv, S, S, hd, hd, bf, win, device,
                                 gen, timed=True),
              "global": bwd_case(B, hq, hkv, S, S, hd, hd, bf, glob, device,
                                 gen, timed=True)}
    rows = [bwd_case(1, hq, hkv, 2048, 2048, hd, hd, bf,
                     {**glob, "window": 1024}, device, gen),
            bwd_case(2, hq, hkv, 200, 200, hd, hd, bf, glob, device, gen),
            bwd_case(2, 8, 2, 256, 256, 64, 64, bf,
                     {"causal": True, "window": 64, "softcap": 0.0}, device,
                     gen),
            bwd_case(B, hq, hkv, S, S, hd, hd, f32, glob, device, gen),
            bwd_case(2, 8, 2, 200, 200, 64, 64, f32,
                     {"causal": True, "window": 64, "softcap": 30.0},
                     device, gen)]
    return {"layers": layers, "rows": rows}


def lm_train_run(ckpt_dir: str) -> tuple:
    """gemma2-2b at full width through the launcher: LM_TRAIN_STEPS AdamW
    steps on batch x seq, no checkpoint written (every 1000 steps)."""
    from repro_torch.launch import train as train_launcher
    rc, trainer = train_launcher.run([
        "--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_STEPS),
        "--batch", str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
        "--ckpt-every", "1000", "--ckpt-dir", ckpt_dir])
    if rc != 0:
        fail(f"lm_train: repro_torch.launch.train exited {rc}")
    return trainer


def plain_step_one(trainer, batch) -> dict:
    """Step 1's loss and gradient norm from a fresh trainer of the same
    config (the same seed: the same weights) on the same batch, with the
    kernels' route (``auto``) and with the plain attention, the optimizer
    not applied."""
    from repro_torch.optim import adamw
    step = trainer._step_fn
    out = {}
    for impl in ("auto", "plain"):
        step.cast_params(trainer.opt_state["master"]).attn_impl = impl
        loss, _, grads = step.grads(trainer.opt_state, batch)
        out[impl] = {"loss": float(loss),
                     "grad_norm": float(adamw.global_norm(grads))}
        del grads
    step.model.attn_impl = "auto"
    return out


def lm_train_restart(device, arch: str = RESTART_ARCH,
                     seq: int = 16) -> dict:
    """tests/test_runtime.py's restart test on the card at ``arch``'s smoke
    width (``seq`` tokens a row): the uninterrupted run and the run failing
    at RESTART_FAIL_AT, recovered from its last checkpoint; losses and
    final state held bit for bit."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import SimulatedFailure, Trainer, TrainerConfig
    cfg = get_config(arch, smoke=True)
    runs = []
    for fail_at in (set(), {RESTART_FAIL_AT}):
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=seq, global_batch=4,
                                         seed=7),
                         TrainerConfig(steps=RESTART_STEPS,
                                       ckpt_every=RESTART_EVERY, ckpt_dir=d,
                                       warmup=2,
                                       adamw=AdamWConfig(lr=1e-3)),
                         device=device)

            def inject(step, fail_at=fail_at):
                if step in fail_at:
                    fail_at.discard(step)
                    raise SimulatedFailure()

            t0 = time.perf_counter()
            hist = tr.train(failure_injector=inject)
            runs.append((hist, tr.opt_state, time.perf_counter() - t0))
    (h1, s1, w1), (h2, s2, w2) = runs
    a = {h["step"]: h["loss"] for h in h1}
    b = {h["step"]: h["loss"] for h in h2}
    differ = [f"{part}/{n}" for part in ("master", "m", "v")
              for n, t in s1[part].items() if not torch.equal(t, s2[part][n])]
    if a != {s: b[s] for s in a} or differ or len(h2) != len(h1) + 1:
        fail(f"{arch} restart: losses {a} vs {b}, {len(h2)} records, "
             f"differing leaves {differ[:5]}")
    return {"arch": arch, "seq": seq, "steps": RESTART_STEPS,
            "ckpt_every": RESTART_EVERY, "failed_at": RESTART_FAIL_AT,
            "losses": [a[s] for s in sorted(a)], "records_recovered": len(h2),
            "bit_equal": True, "wall_s": w1, "recovered_wall_s": w2}


def phase_lm_train(device, smi) -> dict:
    from repro_torch.data import make_batch
    gc.collect()
    torch.cuda.empty_cache()
    cublas_warm(device)
    bytes_before = torch.cuda.memory_allocated(device)
    cfg = get_config(LM_TRAIN_ARCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    bwd = lm_train_bwd_cases(cfg, device, gen)

    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        # -- the main path: every launch count is 0 just before, read after
        reset_launches()
        trainer = lm_train_run(ckpt_dir)
        launches = read_launches()
        # -----------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated(device)
        hist = trainer.history
        n = cfg.n_layers * LM_TRAIN_STEPS
        expected = launches_of(flash_attention=3 * n,
                               flash_attention_wgmma=n,
                               flash_attention_bwd_dq=n,
                               flash_attention_bwd_dq_ffma=n,
                               flash_attention_bwd_dkdv=n)
        if launches != expected:
            fail(f"lm_train: launches {launches}; expected {expected}")
        if len(hist) != LM_TRAIN_STEPS or not all(
                math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist):
            fail(f"lm_train: history {hist}")
        walls = [h["wall"] * 1e3 for h in hist]
        batch7 = trainer._batch(make_batch(trainer.data_cfg, LM_TRAIN_STEPS))
        profile = device_profile(lambda: trainer._step_fn(trainer.opt_state,
                                                          batch7),
                                 LM_TRAIN_GROUPS)
        params = sum(t.numel() for t in trainer.opt_state["master"].values())
        dcfg, tcfg = trainer.data_cfg, trainer.tcfg
        del trainer, batch7
        gc.collect()
        torch.cuda.empty_cache()
        # step 1 again from the same seed and batch: kernels, plain attention
        from repro_torch.runtime import Trainer
        fresh = Trainer(cfg, dcfg, tcfg, device=device)
        fresh.init_state()
        one = plain_step_one(fresh, fresh._batch(make_batch(dcfg, 0)))
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    k1 = {"loss": hist[0]["loss"], "grad_norm": hist[0]["grad_norm"]}
    pl = one["plain"]
    dl = abs(k1["loss"] - pl["loss"])
    dg = abs(k1["grad_norm"] - pl["grad_norm"])
    if not (dl <= LM_TRAIN_LOSS_RTOL * abs(pl["loss"])
            and dg <= LM_TRAIN_GNORM_RTOL * pl["grad_norm"]):
        fail(f"lm_train: step 1 on the kernels {k1} against the plain "
             f"attention {pl}: over rtol {LM_TRAIN_LOSS_RTOL} (loss) / "
             f"{LM_TRAIN_GNORM_RTOL} (grad norm)")
    restart = lm_train_restart(device)
    gc.collect()
    torch.cuda.empty_cache()
    bytes_after = torch.cuda.memory_allocated(device)

    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    out = {"phase": "lm_train", "arch": LM_TRAIN_ARCH, "path": LM_TRAIN_PATH,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": params,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "steps": LM_TRAIN_STEPS, "launches": launches,
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_ms": walls,
           "ms_per_step_median_2_6": statistics.median(walls[1:]),
           "first_step_ms": walls[0],
           "max_memory_allocated_gb": peak / 1e9,
           "bounds_ms": {
               "products_6ND_bf16": 6.0 * params * tokens
               / H100_SXM.peak_flops * 1e3,
               "adamw_bytes": lm_adamw_bytes(params) / H100_SXM.hbm_bw
               * 1e3},
           "profile_step": profile,
           "step1": {"kernels": k1, "plain_attention": pl,
                     "kernels_recomputed": one["auto"],
                     "loss_rtol": LM_TRAIN_LOSS_RTOL,
                     "grad_norm_rtol": LM_TRAIN_GNORM_RTOL},
           "backward_kernels": bwd, "restart": restart,
           "card_bytes_before": bytes_before, "card_bytes_after":
               bytes_after, "nvidia_smi": smi}
    emit(out)
    return out


def lm_adamw_bytes(params: int) -> int:
    """Bytes one AdamW step must move for ``params`` parameters with bf16
    weights and gradients: the bf16 gradient read, master, m and v (f32)
    read and written, the bf16 weight written for the next forward."""
    return params * (2 + 3 * 4 * 2 + 2)


def flash_bwd_entries(lm_train: dict, ssm_train: dict) -> list:
    """The kernels line's three backward-kernel entries.  The FFMA dQ and
    the dK/dV kernel: one launch each at gemma2-2b's global-layer train
    shape (the window layer and zamba2-7b's shared attention beside it),
    the plain backward and SDPA's backward (both kernels' work) at that
    shape.  The tensor-core dQ kernel: one launch at zamba2-7b's shared
    attention, the FFMA dQ kernel's time there beside it, the plain and
    SDPA's backward at that shape.  Launches on gemma2's and zamba2's
    train paths; each kernel's ``max_abs_err`` over the cases it ran."""
    zflash = ssm_train["backward_kernels"]["flash_zamba2"]
    ztrain = ssm_train["zamba2"]
    glob = lm_train["backward_kernels"]["layers"]["global"]
    win = lm_train["backward_kernels"]["layers"]["window"]
    rows = [glob, win, zflash] + lm_train["backward_kernels"]["rows"]
    shape = (f"B={glob['b']}, Hq={glob['hq']}, Hkv={glob['hkv']}, "
             f"S={glob['sq']}, D={glob['d']}, causal, soft-cap "
             f"{glob['softcap']}, bf16")
    zshape = (f"B={zflash['b']}, H={zflash['hq']}, S={zflash['sq']}, "
              f"D={zflash['d']}, causal, bf16")

    def by_path(counter):
        return {LM_TRAIN_PATH: lm_train["launches"][counter],
                ztrain["path"]: ztrain["launches"][counter]}
    out = []
    for which, kernel, counter in (
            ("dq", "flash_attention_bwd_dq", "flash_attention_bwd_dq_ffma"),
            ("dkdv", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dkdv")):
        parts = ("dq",) if which == "dq" else ("dk", "dv")
        mine = [r for r in rows if which == "dkdv"
                or r["dq_route"] == "ffma"]
        zms = zflash["kernel_ms"]["dq_ffma" if which == "dq" else which]
        out.append({
            "name": f"{kernel}_kernel", "route": "cuda",
            "source": FLASH_CSRC + "flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
            "function": "the gradient of flash_attention_pallas (the JAX "
                        "package differentiates its route; it has no "
                        "backward kernel)",
            "launches": sum(by_path(counter).values()),
            "launches_by_path": by_path(counter),
            "max_abs_err": max(r[w]["max_abs_err"] for r in mine
                               for w in parts),
            "ms": glob["kernel_ms"][which],
            "plain_ms": glob["plain_ms"],
            "bound_ms": glob["bound_ms"][which],
            "bound_by": glob["bound_by"][which],
            "library_ms": glob["library_ms"],
            "library_call": glob["library_call"],
            "window_layer": {"ms": win["kernel_ms"][which],
                             "bound_ms": win["bound_ms"][which]},
            HYBRID_ARCH: {"ms": zms,
                          "on_path": which == "dkdv",
                          "bound_ms": zflash["bound_ms"][which],
                          "bound_by": zflash["bound_by"][which],
                          "plain_ms": zflash["plain_ms"],
                          "library_ms": zflash["library_ms"],
                          "at": zshape},
            "at": f"one launch at the {LM_TRAIN_ARCH} global-layer train "
                  f"shape ({shape}); plain_ms and library_ms: the whole "
                  f"backward (dq and dk/dv) of the plain version and of "
                  f"SDPA (no soft-cap); max_abs_err: the largest "
                  f"{' and '.join(parts)} error over every case it ran"})
    tc_rows = [r for r in rows if r["dq_route"] == "tc"]
    out.append({
        "name": "flash_attention_bwd_dq_kernel_wgmma", "route": "cuda",
        "source": FLASH_CSRC + "flash_attention_bwd_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
        "function": "dQ and the row statistics of the gradient of "
                    "flash_attention_pallas, bf16 up to 128 padded columns "
                    "(the JAX package differentiates its route; it has no "
                    "backward kernel)",
        "launches": sum(by_path("flash_attention_bwd_dq_tc").values()),
        "launches_by_path": by_path("flash_attention_bwd_dq_tc"),
        "max_abs_err": max(r["dq"]["max_abs_err"] for r in tc_rows),
        "max_row_rel_err": max(r["dq"]["max_row_rel_err"] for r in tc_rows),
        "stats_max_abs_err": {w: max(r["stats"][w]["max_abs_err"]
                                     for r in tc_rows)
                              for w in ("lse", "delta")},
        "ds_terms": flash_ops._lib().repro_flash_bwd_dq_tc_ds_terms(),
        "dq_share_of_limit": {w: max(r["dq"]["share_of_limit"][w]
                                     for r in tc_rows)
                              for w in ("elementwise", "row")},
        "ms": zflash["kernel_ms"]["dq"],
        "ffma_dq_ms": zflash["kernel_ms"]["dq_ffma"],
        "dkdv_ms": zflash["kernel_ms"]["dkdv"],
        "both_kernels_ms": zflash["both_kernels_ms"],
        "plain_ms": zflash["plain_ms"],
        "bound_ms": zflash["bound_ms"]["dq"],
        "bound_by": zflash["bound_by"]["dq"],
        "library_ms": zflash["library_ms"],
        "library_call": zflash["library_call"],
        "at": f"one launch at the {HYBRID_ARCH} shared attention's train "
              f"shape ({zshape}); ffma_dq_ms: the FFMA dQ kernel there; "
              f"plain_ms and library_ms: the whole backward (dq and dk/dv) "
              f"of the plain version and of SDPA; max_abs_err: the largest "
              f"dq error over every case it ran"})
    return out


# ------------------------------------------------------------- ssm_train
SSM_TRAIN_STEPS = 6
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 8, 2048         # 16 chunks of 128
SSM_TRAIN_PATH = "mamba2-130m-train-8x2048"
HYBRID_TRAIN_LAYERS = 12                          # 2 groups of 6 of 78
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ = 4, 1024
HYBRID_TRAIN_PATH = "zamba2-7b-12L-train-4x1024"
SSM_TRAIN_SEEDS = (0, 1, 2)                       # step 1 against the plain SSD
SSM_RESTART_SEQ = 40                              # the smoke's chunk is 16
# The SSD backward kernels against the plain backward computed in f64
# (ssd_scan_bwd_ref, autograd through the chunked scan), set before their
# first card run.  Each gradient (dx, ddt, dA, dB, dC) sums terms of either
# sign over the chunk and the carried states, as the forward's output does,
# so its rounding scales with its largest value: max |err| within
# SSD_TOL·max|ref| of that gradient, and each row (the last dim: P of dx, H
# of ddt, N of dB and dC, all of dA) within SSD_ROW_TOL of the row's norm —
# the forward's limits (f32 1e-4 and 1e-3; bf16 1e-2, a gradient rounded
# once to bf16 lying up to 2^-9 of each value off).  The f32 kernels sum
# C·B and dy·x in f64, as the f32 forward sums C·B; the smoke's
# strong-decay case (dt·A near -20 a step) holds dA, which an f32 sum of
# da's cancelling diagonal would lose.
SSD_BWD_GRADS = ("x", "dt", "A", "B", "C")
# Step 1 of a bf16 train path on the kernels against the plain SSD
# (ssd_impl="plain"), leaf by leaf.  These random models amplify the
# rounding of their bf16 activations: a change of rounding alone moves
# their gradient leaves by several % to tens of % (JAX's model alike:
# tests/test_torch_trainer.py::test_bf16_rounding_floor_is_the_models_own),
# so no fixed limit on the bf16 gradient tells right from wrong.  Each
# leaf's distance from the plain SSD's gradient (the norm of the
# difference over the norm) is held within SSD_TRAIN_FLOOR_FACTOR times
# that leaf's floor, measured in the same run from the same weights and
# batch: the larger of its distances to two other correct SSDs, the plain
# scan computed in f64 (y rounded once to bf16) and in chunks of half the
# model's, and never less than one bf16 rounding (2^-8).  Set before its
# first card run, from tools/ssd_train_floor.py on the CPU (mamba2-130m, 24
# layers, one row of 512 tokens, seeds 0-2): three more correct SSDs (f64
# forward with the f32 backward, chunks of a quarter, f64 in chunks of
# half) lay at most 1.85 floors from the plain SSD at their worst leaf.
SSD_TRAIN_FLOOR_FACTOR = 3.0
BF16_ROUNDING = 2.0 ** -8
SSM_TRAIN_GROUPS = (("ssd_backward", ("ssd_scan_bwd",)),
                    ("ssd_forward", ("ssd_scan_kernel",)),
                    ("flash_backward", ("flash_attention_bwd",)),
                    ("flash_forward", ("flash_attention_kernel",)),
                    ("gemm", GEMM_NAMES),
                    ("elementwise_and_adamw", LM_TRAIN_GROUPS[-1][1]))


def ssd_bwd_errors(g, w, dtype, name: str) -> dict:
    """One kernel gradient or buffer ``g`` (as f32) against the f64 plain
    one ``w``: max |err| within ``SSD_TOL[dtype]·max|w|`` and each row's
    error (the last dim; dA is one row) within ``SSD_ROW_TOL[dtype]`` of
    the row's norm.  ``fault`` says what failed (d<name> for a gradient of
    ``SSD_BWD_GRADS``, else ``name``), or is None."""
    what = f"d{name}" if name in SSD_BWD_GRADS else name
    g, w = g.double(), w.double()
    if name == "A":
        g, w = g[None], w[None]
    err = (g - w).abs().max().item()
    atol = SSD_TOL[dtype] * w.abs().max().item()
    row = ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max() \
        .item()
    fault = None
    if not bool(torch.isfinite(g).all()):
        fault = f"{what} not finite"
    elif not err <= atol:
        fault = f"{what}: max |err| {err} over {atol}"
    elif not row <= SSD_ROW_TOL[dtype]:
        fault = (f"{what}: a row's error is {row} of its norm, over "
                 f"{SSD_ROW_TOL[dtype]}")
    return {"max_abs_err": err, "atol": atol, "max_row_rel_err": row,
            "row_rel_tol": SSD_ROW_TOL[dtype],
            "max_abs_ref": w.abs().max().item(), "fault": fault}


def ssd_bwd_bound_times(b, s, h, p, n, chunk, dtype,
                        parts: int = 0) -> dict:
    """(bytes_ms, operations_ms, buffers_ms) on an H100 SXM of each
    backward kernel and of the whole gradient.  bytes_ms: the function's
    own inputs (x, dt, A, B, C, dy) read once and its gradients written
    once, each counted at the kernel that reads or writes it.  buffers_ms:
    the bytes of the design's own buffers (each chunk's S_in and G, the
    partials of dB and dC, ``parts`` of them a row — the heads by default,
    the chunk kernel's head splits on the tensor-core route — and of dA),
    written once and read once, which the function does not need: not in
    the bound, reported beside it.  operations_ms at the type's peak: a
    state pass 2·B·H·S·N·P; the chunk kernel C·Bᵀ over each chunk's lower
    triangle once per batch row, and per head dy·xᵀ and the intra-chunk
    products of dx, dB and dC over it, and three L·N·P state products a
    chunk; the reduction the head sums of dB and dC."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nc = -(-s // chunk)
    lens = [min(chunk, s - s0) for s0 in range(0, s, chunk)]
    pairs = sum(L * (L + 1) // 2 for L in lens)
    xs, bs, dts = b * s * h * p * isz, b * s * n * isz, b * s * h * 4
    states = b * nc * h * n * p * 4
    partials = 2 * b * s * (parts or h) * n * 4 + b * nc * h * 4
    state_ops = 2.0 * b * h * s * n * p
    chunk_ops = 2.0 * b * pairs * n + 2.0 * b * h * (
        pairs * (2 * p + 2 * n) + 3.0 * s * n * p)
    reduce_ops = 2.0 * b * s * h * n
    peak = PEAK[dtype]

    def times(nbytes, ops, buffers):
        return (nbytes / H100_SXM.hbm_bw * 1e3, ops / peak * 1e3,
                buffers / H100_SXM.hbm_bw * 1e3)
    return {
        # x, B, dt read; S_in written (a buffer)
        "state": times(xs + bs + dts, state_ops, states),
        # dy, C, dt read; G written (a buffer)
        "dstate": times(xs + bs + dts, state_ops, states),
        # x, dy, dt, B, C read, dx and ddt written; S_in and G read, the
        # partials written (buffers)
        "chunk": times(3 * xs + 2 * bs + 2 * dts, chunk_ops,
                       2 * states + partials),
        # dB, dC, dA written; the partials read (buffers)
        "reduce": times(2 * bs + h * 4, reduce_ops, partials),
        "gradient": times(3 * xs + 4 * bs + 2 * dts + 2 * h * 4,
                          2 * state_ops + chunk_ops + reduce_ops,
                          4 * states + 2 * partials)}


def ssd_bwd_kernel_ms(x, dt, A, bm, cm, dy, chunk, device,
                      iters: int = 10) -> dict:
    """Device ms of one launch of each backward kernel of the route alone:
    the four once in order (so the chunk and reduce kernels read filled
    buffers), then CUDA events around ``iters`` back-to-back launches of
    each through its C entry point; these launches are not counted."""
    _, call = ssd_ops._bwd_call(x, dt, A, bm, cm, dy, chunk)
    kernels, args, _ = call
    lib = ssd_ops._lib()
    fns = {name: getattr(lib, entry) for name, entry, _ in kernels}

    def launch(name):
        rc = fns[name](*args)
        if rc != 0:
            fail(f"SSD backward {name} kernel: launch error {rc}")
    for name in fns:
        launch(name)
    return {name: timed_ms(lambda name=name: launch(name), device, iters)
            for name in fns}


def ssd_bwd_counts() -> tuple:
    """(state, dstate, chunk, reduce; the tensor-core state, dstate and
    chunk kernels; the FFMA state, dstate and chunk kernels)."""
    return (ssd_ops.BWD_STATE_LAUNCHES, ssd_ops.BWD_DSTATE_LAUNCHES,
            ssd_ops.BWD_CHUNK_LAUNCHES, ssd_ops.BWD_REDUCE_LAUNCHES,
            ssd_ops.BWD_STATE_TC_LAUNCHES, ssd_ops.BWD_DSTATE_TC_LAUNCHES,
            ssd_ops.BWD_CHUNK_TC_LAUNCHES, ssd_ops.BWD_STATE_FFMA_LAUNCHES,
            ssd_ops.BWD_DSTATE_FFMA_LAUNCHES,
            ssd_ops.BWD_CHUNK_FFMA_LAUNCHES)


SSD_BWD_ROUTE_LAUNCHES = {"tc": (1, 1, 1, 1, 1, 1, 1, 0, 0, 0),
                          "ffma": (1, 1, 1, 1, 0, 0, 0, 1, 1, 1)}


def ssd_bwd_state_buffers(x, dt, A, bm, cm, dy, chunk) -> tuple:
    """The route's two state passes alone, launched through
    ``ssd_ops._bwd_call``'s entry points as :func:`ssd_bwd_kernel_ms`
    launches them (not counted), and held against ``ssd_bwd_states_ref``
    computed in f64; fails nothing.  Returns ``(rcs, (S_in, G), errs)``:
    each entry point's launch code, each chunk's S_in and G buffers,
    ``(B, nC, H, N, P)`` f32, and for each :func:`ssd_bwd_errors` at the
    f32 limits on both routes — max |err| within ``SSD_TOL[f32]`` = 1e-4
    of the buffer's largest |value|, each row (P values) within
    ``SSD_ROW_TOL[f32]`` = 1e-3 of its norm, every value finite: the
    buffers are f32 on both routes, and the tensor-core passes'
    three-term x̃ and dỹ are exact to ~2^-24, as f32."""
    from repro_torch.kernels.ssd_scan.ref import ssd_bwd_states_ref
    c = min(chunk, x.shape[1], ssd_ops.MAX_CHUNK)
    _, call = ssd_ops._bwd_call(x, dt, A, bm, cm, dy, c)
    kernels, args, (_, bufs) = call
    lib = ssd_ops._lib()
    rcs = {entry: getattr(lib, entry)(*args) for _, entry, _ in kernels[:2]}
    want = ssd_bwd_states_ref(*(t.double() for t in (x, dt, A, bm, cm, dy)),
                              c)
    torch.cuda.synchronize(x.device)
    errs = {key: ssd_bwd_errors(got, w, torch.float32, key)
            for key, got, w in zip(("S_in", "G"), bufs[:2], want)}
    return rcs, tuple(bufs[:2]), errs


def ssd_bwd_state_errors(x, dt, A, bm, cm, dy, chunk, name) -> dict:
    """:func:`ssd_bwd_state_buffers`' errors of the S_in and G buffers;
    fails on a launch error or a fault."""
    rcs, _, errs = ssd_bwd_state_buffers(x, dt, A, bm, cm, dy, chunk)
    for entry, rc in rcs.items():
        if rc != 0:
            fail(f"{name}: {entry}: launch error {rc}")
    for key, e in errs.items():
        if e["fault"] is not None:
            fail(f"{name}: {e['fault']}")
        del e["fault"]
    return errs


def ssd_bwd_case(b, s, h, p, n, chunk, dtype, device, gen, strided=True,
                 strong=False, timed=False) -> dict:
    """The four backward kernels (``ssd_scan_bwd``, impl ``"kernel"``) on
    one input and output gradient against ``ssd_scan_bwd_ref`` computed in
    f64: each of the five gradients within :func:`ssd_bwd_errors`' limits;
    one launch of each kernel, the state passes and the chunk kernel the
    type's (bf16 the tensor-core ones, f32 the FFMA ones) and the other
    route's none; a second call bit-equal to the first; the S_in and G
    buffers of the state passes within :func:`ssd_bwd_state_buffers`'
    limits.  ``strong``: dt·A between -22 and -20 every step.  ``timed``:
    each kernel's device ms, the four in one call, the plain backward in
    the working type (and its two state passes alone,
    ``ssd_bwd_states_ref``), and the bounds."""
    from repro_torch.kernels.ssd_scan.ref import (ssd_bwd_states_ref,
                                                  ssd_scan_bwd_ref)
    x, dt, A, bm, cm = ssd_inputs(b, s, h, p, n, dtype, device, gen,
                                  strided)
    if strong:
        dt = 1.0 + 0.1 * torch.rand(dt.shape, generator=gen, device=device)
        A = torch.full_like(A, -20.0)
    dy = torch.randn(x.shape, generator=gen, device=device).to(dtype)
    before = ssd_bwd_counts()
    got = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, chunk=chunk,
                               impl="kernel")
    launched = tuple(a - c for a, c in zip(ssd_bwd_counts(), before))
    again = ssd_ops.ssd_scan_bwd(x, dt, A, bm, cm, dy, chunk=chunk,
                                 impl="kernel")
    want = ssd_scan_bwd_ref(*(t.double() for t in (x, dt, A, bm, cm, dy)),
                            min(chunk, s))
    torch.cuda.synchronize(device)
    name = (f"ssd_scan_bwd b{b} s{s} h{h} p{p} n{n} chunk{chunk} {dtype}"
            f"{' strided' if strided else ''}{' strong' if strong else ''}")
    route = "tc" if dtype == torch.bfloat16 else "ffma"
    if launched != SSD_BWD_ROUTE_LAUNCHES[route]:
        fail(f"{name}: (state, dstate, chunk, reduce, tensor-core state, "
             f"dstate, chunk, FFMA state, dstate, chunk) launches "
             f"{launched}")
    ins = (x, dt, A, bm, cm)
    nc = -(-s // min(chunk, 128))
    splits = ssd_ops.plan_splits(b, nc, h, torch.cuda.get_device_properties(
        device).multi_processor_count) if route == "tc" else h
    row = {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
           "dtype": str(dtype).split(".")[-1], "bc_strided": strided,
           "strong_decay": strong, "chunk_kernel": route,
           "partial_parts": splits}
    for gname, g, g2, w, t in zip(SSD_BWD_GRADS, got, again, want, ins):
        if g.shape != t.shape or g.dtype != t.dtype:
            fail(f"{name}: d{gname} {tuple(g.shape)} {g.dtype}")
        if not torch.equal(g, g2):
            fail(f"{name}: d{gname} differs between two calls")
        errs = ssd_bwd_errors(g.float(), w, dtype, gname)
        fault = errs.pop("fault")
        if fault is not None:
            fail(f"{name}: {fault}")
        row["d" + gname] = errs
    row["bit_equal_repeat"] = True
    row["max_abs_err"] = max(row["d" + g]["max_abs_err"]
                             for g in SSD_BWD_GRADS)
    del got, again, want
    row["states"] = ssd_bwd_state_errors(x, dt, A, bm, cm, dy, chunk, name)
    if timed:
        bounds = ssd_bwd_bound_times(b, s, h, p, n, min(chunk, 128), dtype,
                                     splits)
        row["kernel_ms"] = ssd_bwd_kernel_ms(x, dt, A, bm, cm, dy,
                                             min(chunk, s), device)
        row["all_kernels_ms"] = timed_ms(lambda: ssd_ops.ssd_scan_bwd(
            x, dt, A, bm, cm, dy, chunk=chunk, impl="kernel"), device, 5)
        row["plain_ms"] = timed_ms(lambda: ssd_scan_bwd_ref(
            x, dt, A, bm, cm, dy, min(chunk, s)), device, 3, warmup=1)
        row["states_plain_ms"] = timed_ms(lambda: ssd_bwd_states_ref(
            x, dt, A, bm, cm, dy, min(chunk, s, 128)), device, 3, warmup=1)
        row["bound_ms"], row["bound_by"], row["bytes_ms"] = {}, {}, {}
        row["buffers_ms"] = {}
        for which, (t_bytes, t_ops, t_buf) in bounds.items():
            row["bound_ms"][which], row["bound_by"][which] = bound_of(
                t_bytes, t_ops)
            row["bytes_ms"][which] = t_bytes
            row["buffers_ms"][which] = t_buf
    return row


def ssm_train_bwd_cases(device, gen) -> dict:
    """The backward kernels at the JAX kernel tests' cases
    (tests/test_kernels.py:107-139), a ragged S, S < chunk, the default
    chunk 256 (run at 128), N and P off the tiles, B and C contiguous and
    strided, strong decay, in both types; then mamba2-130m's and
    zamba2-7b's layers at their train shapes, in bf16 as the models run
    them and in f32, each timed; and the flash backward at zamba2's shared
    attention (head dim 112, padded to the kernel's 128 template)."""
    cases = [(2, 64, 4, 16, 8, 16), (2, 128, 4, 16, 8, 32),
             (2, 96, 4, 16, 8, 32), (1, 64, 2, 16, 8, 32),
             (1, 128, 2, 16, 8, 64), (2, 200, 4, 16, 8, 128),
             (2, 40, 3, 16, 8, 128), (2, 300, 4, 64, 128, 256),
             (1, 77, 2, 22, 13, 16)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for c in cases:
            rows.append(ssd_bwd_case(*c, dtype, device, gen))
        rows.append(ssd_bwd_case(2, 260, 4, 64, 128, 128, dtype, device,
                                 gen, strided=False))
        rows.append(ssd_bwd_case(2, 256, 4, 64, 128, 128, dtype, device,
                                 gen, strong=True))
    for r in rows:
        emit({"phase": "ssm_train", "ssd_backward": r})
    layers = {}
    for arch, batch, seq in ((SSM_ARCH, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ),
                             (HYBRID_ARCH, HYBRID_TRAIN_BATCH,
                              HYBRID_TRAIN_SEQ)):
        cfg = get_config(arch)
        dims = (batch, seq, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                cfg.ssm_chunk)
        layers[arch] = ssd_bwd_case(*dims, torch.bfloat16, device, gen,
                                    timed=True)
        layers[arch + "_f32"] = ssd_bwd_case(*dims, torch.float32, device,
                                             gen, timed=True)
        for key in (arch, arch + "_f32"):
            emit({"phase": "ssm_train", "at": f"{key} train layer",
                  "ssd_backward": layers[key]})
    zcfg = get_config(HYBRID_ARCH)
    flash = bwd_case(HYBRID_TRAIN_BATCH, zcfg.n_heads, zcfg.n_kv_heads,
                     HYBRID_TRAIN_SEQ, HYBRID_TRAIN_SEQ, zcfg.head_dim,
                     zcfg.head_dim, torch.bfloat16,
                     {"causal": True, "window": 0, "softcap": 0.0}, device,
                     gen, timed=True)
    emit({"phase": "ssm_train", "flash_backward_zamba2": flash})
    return {"rows": rows, "layers": layers, "flash_zamba2": flash}


def ssm_train_launches(cfg, steps: int) -> dict:
    """The counts a train run of ``cfg`` should read: per step one SSD
    forward (tensor-core kernel) and one launch of each backward kernel a
    Mamba2 layer (the tensor-core state passes and chunk kernel, no FFMA
    one), and for the hybrid family one flash forward, one tensor-core dQ
    launch (head dim 112, none of the FFMA dQ kernel) and one dK/dV launch
    a shared-block application; no cast, copy or other kernel."""
    n = cfg.n_layers * steps
    kw = {"ssd_scan": 5 * n, "ssd_scan_wgmma": n, "ssd_scan_bwd": 4 * n,
          "ssd_scan_bwd_state": n, "ssd_scan_bwd_dstate": n,
          "ssd_scan_bwd_chunk": n, "ssd_scan_bwd_state_tc": n,
          "ssd_scan_bwd_dstate_tc": n, "ssd_scan_bwd_chunk_tc": n,
          "ssd_scan_bwd_reduce": n}
    if cfg.family == "hybrid":
        a = n_scan_groups(cfg) * steps
        kw.update(flash_attention=3 * a, flash_attention_wgmma=a,
                  flash_attention_bwd_dq=a, flash_attention_bwd_dq_tc=a,
                  flash_attention_bwd_dkdv=a)
    return launches_of(**kw)


def ssm_train_run(cfg, batch: int, seq: int, ckpt_dir: str,
                  via_launcher: bool):
    """``cfg`` trained for SSM_TRAIN_STEPS AdamW steps on batch x seq, no
    checkpoint written: through the launcher (``run``; mamba2-130m), or
    through ``runtime.Trainer`` as ``run`` builds it (the cut zamba2-7b:
    the launcher takes no depth flag)."""
    if via_launcher:
        from repro_torch.launch import train as train_launcher
        rc, trainer = train_launcher.run([
            "--arch", cfg.name, "--steps", str(SSM_TRAIN_STEPS),
            "--batch", str(batch), "--seq", str(seq),
            "--ckpt-every", "1000", "--ckpt-dir", ckpt_dir])
        if rc != 0:
            fail(f"ssm_train: repro_torch.launch.train exited {rc}")
        return trainer
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, input_mode=cfg.input_mode,
                      d_model=cfg.d_model)
    tcfg = TrainerConfig(steps=SSM_TRAIN_STEPS, ckpt_every=1000,
                         ckpt_dir=ckpt_dir, adamw=AdamWConfig(lr=3e-4))
    trainer = Trainer(cfg, dcfg, tcfg, device="cuda")
    trainer.train()
    return trainer


class PlainScan(torch.autograd.Function):
    """The plain chunked scan with its forward computed in ``fwd`` and its
    backward in ``bwd`` (recomputed from the saved inputs), y and each
    gradient rounded to its input's type."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, fwd, bwd):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk, ctx.bwd = chunk, bwd
        return ssd_chunked_ref(*(t.to(fwd) for t in (x, dt, A, Bm, Cm)),
                               chunk).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
        ins = ctx.saved_tensors
        grads = ssd_scan_bwd_ref(*(t.to(ctx.bwd) for t in ins),
                                 dy.to(ctx.bwd), ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(grads, ins)), None, None,
                None)


def scan_variant(variant: str):
    """A stand-in for the model's ``ssd_scan``, another correct SSD:
    ``"f64"`` (:class:`PlainScan` in f64 at the model's chunk) or
    ``"half"`` (the plain scan in chunks of half the model's)."""
    def scan(x, dt, A, Bm, Cm, chunk=256, impl="auto",
             return_final_state=False):
        c = min(chunk, x.shape[1], ssd_ops.MAX_CHUNK)
        if variant == "f64":
            return PlainScan.apply(x, dt, A, Bm, Cm, c, torch.float64,
                                   torch.float64)
        return ssd_chunked_ref(x, dt, A, Bm, Cm, max(c // 2, 1))
    return scan


def ssd_step_grads(step, master, batch, impl: str = "auto",
                   plain_bwd: bool = False, scan=None) -> tuple:
    """Step 1's ``({"loss", "grad_norm"}, gradients)`` at ``master`` on
    ``batch``, the optimizer not applied, with the SSD scan's ``impl``;
    ``plain_bwd``: the kernels' forward with ``ssd_scan_bwd_ref`` in place
    of the backward kernels (the same activations, only the gradient's
    arithmetic differs); ``scan``: a :func:`scan_variant` in place of the
    model's SSD scan."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    from repro_torch.models import layers as model_layers
    from repro_torch.optim import adamw
    step.cast_params(master).ssd_impl = impl
    launch_bwd, model_scan = ssd_ops._launch_bwd, model_layers.ssd_scan
    if plain_bwd:
        ssd_ops._launch_bwd = lambda x, dt, A, bm, cm, dy, chunk: \
            ssd_scan_bwd_ref(x, dt, A, bm, cm, dy, min(chunk, 128))
    if scan is not None:
        model_layers.ssd_scan = scan
    try:
        loss, _, grads = step.grads({"master": master}, batch)
    finally:
        ssd_ops._launch_bwd, model_layers.ssd_scan = launch_bwd, model_scan
        step.model.ssd_impl = "auto"
    return ({"loss": float(loss),
             "grad_norm": float(adamw.global_norm(grads))}, grads)


def leaf_dists(grads: dict, ref: dict) -> dict:
    """Each leaf's distance from ``ref``'s: the norm of the difference over
    the norm of ``ref``'s leaf."""
    return {n: float((grads[n].float() - ref[n].float()).norm()
                     / ref[n].float().norm().clamp_min(1e-30)) for n in ref}


def bf16_leaf_gate(step, master, batch) -> tuple:
    """Step 1 in bf16 with the plain SSD, the two floor witnesses of
    SSD_TRAIN_FLOOR_FACTOR and the kernels: ``(readings, the kernels' leaf
    distances from the plain SSD's, each leaf's floor, their ratio, the
    leaves over SSD_TRAIN_FLOOR_FACTOR)``."""
    plain, ref = ssd_step_grads(step, master, batch, "plain")
    out, floor = {"plain": plain}, {}
    for name in ("f64", "half"):
        out["plain_" + name], g = ssd_step_grads(step, master, batch,
                                                 "plain",
                                                 scan=scan_variant(name))
        for n, d in leaf_dists(g, ref).items():
            floor[n] = max(floor.get(n, 0.0), d)
        del g
    out["kernels"], g = ssd_step_grads(step, master, batch)
    dist = leaf_dists(g, ref)
    del g, ref
    ratio = {n: dist[n] / max(floor[n], BF16_ROUNDING) for n in dist}
    over = sorted(n for n in ratio if not ratio[n] <= SSD_TRAIN_FLOOR_FACTOR)
    return out, dist, floor, ratio, over


def rel_gap(got: dict, want: dict) -> dict:
    return {k: abs(got[k] - want[k]) / abs(want[k])
            for k in ("loss", "grad_norm")}


def top_leaves(values: dict, k: int = 5) -> list:
    return [[n, values[n]] for n in sorted(values, key=values.get,
                                           reverse=True)[:k]]


def ssd_step_one(trainer, device) -> list:
    """Step 1 for each of SSM_TRAIN_SEEDS (weights drawn from the seed,
    batch number ``seed`` of the data config; seed 0 is the main run's
    first step).  In bf16, the path's type: with the plain SSD
    (``ssd_impl="plain"``) and its two floor witnesses, on the kernels, and
    on the kernels' forward with the plain backward.  In f32 (the same
    config, weights from the same seed: the FFMA forward kernel and the
    backward kernels in f32): on the kernels and with the plain SSD.
    Gated: the bf16 kernels' gradient against the plain SSD's leaf by leaf,
    within SSD_TRAIN_FLOOR_FACTOR of each leaf's floor, and their loss
    within LM_TRAIN_LOSS_RTOL of it; the bf16 kernels against the plain
    backward on the same activations, and the f32 kernels against the plain
    SSD, each within LM_TRAIN_LOSS_RTOL (loss) and LM_TRAIN_GNORM_RTOL
    (grad norm).  Printed, not gated: the bf16 grad norm against the plain
    SSD's, which the floor moves by several %."""
    from repro_torch.data import make_batch
    from repro_torch.models import init_params
    from repro_torch.runtime import make_train_step
    from repro_torch.optim import schedule
    cfg32 = dataclasses.replace(trainer.cfg, dtype="float32")
    step32 = make_train_step(cfg32, trainer.tcfg.adamw, schedule.constant)
    out = []
    trainer.opt_state = None
    for seed in SSM_TRAIN_SEEDS:
        gc.collect()
        torch.cuda.empty_cache()
        batch = trainer._batch(make_batch(trainer.data_cfg, seed))
        master = {n: p.detach().float() for n, p in
                  init_params(trainer.cfg, seed, device=device)
                  .named_parameters()}
        b16, dist, floor, ratio, over = bf16_leaf_gate(trainer._step_fn,
                                                       master, batch)
        b16["plain_backward"] = ssd_step_grads(trainer._step_fn, master,
                                               batch, plain_bwd=True)[0]
        got = {"seed": seed, "bf16": b16,
               "bf16_leaves": {
                   "floor_factor": SSD_TRAIN_FLOOR_FACTOR,
                   "leaves": len(dist),
                   "kernels_median": statistics.median(dist.values()),
                   "floor_median": statistics.median(floor.values()),
                   "nearest_their_limit": [
                       [n, dist[n], floor[n], ratio[n]] for n, _ in
                       top_leaves(ratio)],
                   "floor_moved_most": top_leaves(floor)}}
        del master
        trainer._step_fn.model = None
        gc.collect()
        torch.cuda.empty_cache()
        if over:
            fail(f"ssm_train {trainer.cfg.name}: step 1 (seed {seed}) on the "
                 f"bf16 kernels: {len(over)} gradient leaves beyond "
                 f"{SSD_TRAIN_FLOOR_FACTOR} floors of the plain SSD's: "
                 f"{[[n, dist[n], floor[n]] for n in over[:10]]}; {got}")
        master = dict(init_params(cfg32, seed, device=device)
                      .named_parameters())
        master = {n: p.detach() for n, p in master.items()}
        got["f32"] = {"kernels": ssd_step_grads(step32, master, batch)[0],
                      "plain": ssd_step_grads(step32, master, batch,
                                              "plain")[0]}
        del master, batch
        step32.model = None
        f32 = got["f32"]
        got["gaps"] = {
            "bf16_kernels_vs_plain_backward": rel_gap(b16["kernels"],
                                                      b16["plain_backward"]),
            "f32_kernels_vs_plain": rel_gap(f32["kernels"], f32["plain"]),
            "bf16_kernels_vs_plain": rel_gap(b16["kernels"], b16["plain"]),
            "bf16_plain_f64_vs_plain": rel_gap(b16["plain_f64"],
                                               b16["plain"]),
            "bf16_plain_half_vs_plain": rel_gap(b16["plain_half"],
                                                b16["plain"])}
        gated = [(what, k, v) for what, gap in got["gaps"].items()
                 for k, v in gap.items()
                 if what in ("bf16_kernels_vs_plain_backward",
                             "f32_kernels_vs_plain")
                 or (what == "bf16_kernels_vs_plain" and k == "loss")]
        over = [(what, k, v) for what, k, v in gated
                if v > (LM_TRAIN_LOSS_RTOL if k == "loss"
                        else LM_TRAIN_GNORM_RTOL)]
        if over:
            fail(f"ssm_train {trainer.cfg.name}: step 1 (seed {seed}) over "
                 f"rtol {LM_TRAIN_LOSS_RTOL} (loss) / {LM_TRAIN_GNORM_RTOL} "
                 f"(grad norm): {over}; {got}")
        out.append(got)
    return out


def ssm_train_path(cfg, batch: int, seq: int, path: str, device,
                   via_launcher: bool) -> dict:
    """One train path: the run with every launch count 0 just before and
    read just after, its gates (launches as predicted, every loss and grad
    norm finite, step 1 against the plain SSD on 3 seeds), and its
    readings (ms a step, first step, peak, bounds, a profile of one more
    step by group)."""
    from repro_torch.data import make_batch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        # -- the main path: every launch count is 0 just before, read after
        reset_launches()
        trainer = ssm_train_run(cfg, batch, seq, ckpt_dir, via_launcher)
        launches = read_launches()
        # -----------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated(device)
        hist = trainer.history
        expected = ssm_train_launches(cfg, SSM_TRAIN_STEPS)
        if launches != expected:
            fail(f"ssm_train {path}: launches {launches}; expected "
                 f"{expected}")
        if len(hist) != SSM_TRAIN_STEPS or not all(
                math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist):
            fail(f"ssm_train {path}: history {hist}")
        walls = [h["wall"] * 1e3 for h in hist]
        batch7 = trainer._batch(make_batch(trainer.data_cfg,
                                           SSM_TRAIN_STEPS))
        profile = device_profile(lambda: trainer._step_fn(trainer.opt_state,
                                                          batch7),
                                 SSM_TRAIN_GROUPS)
        params = sum(t.numel() for t in trainer.opt_state["master"].values())
        del batch7
        step_one = ssd_step_one(trainer, device)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    tokens = batch * seq
    return {"arch": cfg.name, "path": path, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "ssd_heads": cfg.ssm_heads, "ssd_state": cfg.ssm_state,
            "params": params, "batch": batch, "seq": seq,
            "steps": SSM_TRAIN_STEPS, "launches": launches,
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_ms": walls,
            "ms_per_step_median_2_6": statistics.median(walls[1:]),
            "first_step_ms": walls[0],
            "max_memory_allocated_gb": peak / 1e9,
            "bounds_ms": {
                "products_6ND_bf16": 6.0 * params * tokens
                / H100_SXM.peak_flops * 1e3,
                "adamw_bytes": lm_adamw_bytes(params) / H100_SXM.hbm_bw
                * 1e3},
            "profile_step": profile,
            "step1": step_one,
            "step1_recomputed_equal": step_one[0]["bf16"]["kernels"]["loss"]
            == hist[0]["loss"],
            "loss_rtol": LM_TRAIN_LOSS_RTOL,
            "grad_norm_rtol": LM_TRAIN_GNORM_RTOL}


def phase_ssm_train(device, smi) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    cublas_warm(device)
    bytes_before = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    bwd = ssm_train_bwd_cases(device, gen)
    mamba2 = ssm_train_path(get_config(SSM_ARCH), SSM_TRAIN_BATCH,
                            SSM_TRAIN_SEQ, SSM_TRAIN_PATH, device, True)
    emit({"phase": "ssm_train", **mamba2, "nvidia_smi": smi})
    zcfg = dataclasses.replace(get_config(HYBRID_ARCH),
                               n_layers=HYBRID_TRAIN_LAYERS)
    zamba2 = ssm_train_path(zcfg, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ,
                            HYBRID_TRAIN_PATH, device, False)
    emit({"phase": "ssm_train", **zamba2,
          "full_depth_layers": get_config(HYBRID_ARCH).n_layers,
          "nvidia_smi": smi})
    restart = lm_train_restart(device, SSM_ARCH, seq=SSM_RESTART_SEQ)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"phase": "ssm_train", "backward_kernels": bwd,
           "mamba2": mamba2, "zamba2": zamba2, "restart": restart,
           "card_bytes_before": bytes_before,
           "card_bytes_after": torch.cuda.memory_allocated(device),
           "nvidia_smi": smi}
    emit({"phase": "ssm_train", "restart": restart,
          "card_bytes_before": bytes_before,
          "card_bytes_after": out["card_bytes_after"]})
    return out


def ssd_bwd_entries(ssm_train: dict) -> list:
    """The kernels line's seven SSD backward entries: one launch each at
    mamba2-130m's train layer (zamba2-7b's beside it) — in bf16, as the
    models run it, but for the FFMA state passes and chunk kernel, which
    take f32 only and are timed at the layers in f32 — the plain backward
    at that shape and type (for a state pass ``ssd_bwd_states_ref``, both
    passes), no library call.  A state pass's ``max_abs_err`` is its
    buffer's (S_in or G) largest error over every case of its type, a
    chunk kernel's the largest gradient error over every case of its type,
    the reduction's over every case."""
    layers = ssm_train["backward_kernels"]["layers"]
    rows = ssm_train["backward_kernels"]["rows"] + list(layers.values())
    paths = (ssm_train["mamba2"], ssm_train["zamba2"])
    out = []
    for name, key, src, f32 in (
            ("ssd_scan_bwd_state_kernel_wgmma", "state_tc",
             "ssd_scan_bwd_state_wgmma.cu", False),
            ("ssd_scan_bwd_dstate_kernel_wgmma", "dstate_tc",
             "ssd_scan_bwd_state_wgmma.cu", False),
            ("ssd_scan_bwd_state_kernel", "state_ffma", "ssd_scan_bwd.cu",
             True),
            ("ssd_scan_bwd_dstate_kernel", "dstate_ffma", "ssd_scan_bwd.cu",
             True),
            ("ssd_scan_bwd_chunk_kernel_wgmma", "chunk_tc",
             "ssd_scan_bwd_wgmma.cu", False),
            ("ssd_scan_bwd_chunk_kernel", "chunk_ffma", "ssd_scan_bwd.cu",
             True),
            ("ssd_scan_bwd_reduce_kernel", "reduce", "ssd_scan_bwd.cu",
             False)):
        which = key.split("_")[0]
        layer = layers[SSM_ARCH + ("_f32" if f32 else "")]
        zlayer = layers[HYBRID_ARCH + ("_f32" if f32 else "")]
        mine, of_type = rows, ""
        if "_" in key:
            of_type = " of its type"
            mine = [r for r in rows if r["dtype"] == layer["dtype"]]
        plain, plain_what = "plain_ms", ("the whole plain backward "
                                         "(autograd through the chunked "
                                         "scan)")
        if which == "chunk" or which == "reduce":
            err, of_what = max(r["max_abs_err"] for r in mine), "gradient"
        else:
            buf = "S_in" if which == "state" else "G"
            err = max(r["states"][buf]["max_abs_err"] for r in mine)
            of_what = f"{buf} buffer"
            plain = "states_plain_ms"
            plain_what = "ssd_bwd_states_ref, both state passes,"
        shape = (f"B={layer['b']}, S={layer['s']}, H={layer['h']}, "
                 f"P={layer['p']}, N={layer['n']}, L={layer['chunk']}, "
                 f"{layer['dtype']}")
        by = {p["path"]: p["launches"]["ssd_scan_bwd_" + key]
              for p in paths}
        out.append({
            "name": name, "route": "cuda", "source": SSD_CSRC + src,
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:73",
            "function": "the gradient of ssd_scan_pallas (the JAX package "
                        "differentiates its jnp route; it has no backward "
                        "kernel)",
            "launches": sum(by.values()), "launches_by_path": by,
            "max_abs_err": err,
            "ms": layer["kernel_ms"][which],
            "plain_ms": layer[plain],
            "bound_ms": layer["bound_ms"][which],
            "bound_by": layer["bound_by"][which],
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes the "
                            "SSD scan's gradient",
            "buffers_ms": layer["buffers_ms"][which],
            HYBRID_ARCH: {"ms": zlayer["kernel_ms"][which],
                          "bound_ms": zlayer["bound_ms"][which],
                          "bound_by": zlayer["bound_by"][which],
                          "buffers_ms": zlayer["buffers_ms"][which],
                          "plain_ms": zlayer[plain]},
            "gradient_ms": layer["all_kernels_ms"],
            "gradient_bound_ms": layer["bound_ms"]["gradient"],
            "gradient_buffers_ms": layer["buffers_ms"]["gradient"],
            "at": f"one launch at the {SSM_ARCH} train layer ({shape}); "
                  f"plain_ms: {plain_what} at that shape; bound_ms: the "
                  f"function's own inputs and gradients that this kernel "
                  f"reads or writes, or its operations at the type's "
                  f"peak; buffers_ms: the design's own buffers (S_in, G, "
                  f"the partials: per head on the FFMA route, per block "
                  f"on the tensor-core one) at the HBM rate, not in the "
                  f"bound; max_abs_err: the largest {of_what} error over "
                  f"every case{of_type}"})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(device)
    phase_build()
    phase_lint()
    gen = torch.Generator(device=device).manual_seed(SEED)
    cfg = speech(100_000)
    d_in, d_hidden, d_out = cfg.d_in, cfg.d_hidden, cfg.d_out
    rows, reduce_rows = phase_kernels(device, d_in, d_hidden, d_out, gen)
    skinny = phase_skinny(device, d_in, d_hidden, d_out)
    flash = phase_flash(device, gen)
    serve = phase_serve(device)
    train = phase_train(device)
    ckpt = phase_ckpt(device)
    mesh = phase_mesh(device, smi)
    oocore = phase_oocore(device)
    gemma2 = phase_gemma2(device)
    ssd = phase_ssd(device, gen)
    mamba2 = phase_mamba2(device)
    zamba2 = phase_zamba2(device)
    phase_lm_serve(device, smi)
    lm_train = phase_lm_train(device, smi)
    ssm_train = phase_ssm_train(device, smi)
    emit({"kernels": [*matmul_entries(rows, reduce_rows, skinny, serve,
                                      train, oocore, ckpt, mesh),
                      *flash_entries(flash, gemma2, zamba2),
                      *flash_bwd_entries(lm_train, ssm_train),
                      *ssd_entries(ssd, mamba2, zamba2, ssm_train),
                      *ssd_bwd_entries(ssm_train)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
