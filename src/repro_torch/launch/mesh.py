"""Meshes of ranks, and the ranks themselves.

Port of ``repro.launch.mesh``.  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, whose dimension names are JAX's mesh axis names
(``mesh.mesh_dim_names``); ``Engine(mesh)`` reads its axes and sizes from
it as the JAX engine reads ``mesh.axis_names`` and ``mesh.shape``.

Deviations from the JAX module:

* JAX runs one controller over many devices; torch runs one process per
  rank.  A mesh needs the process group first: :func:`init_sites` joins
  one (from torchrun's environment, or a store the caller gives), and
  :func:`run_sites` spawns the ranks of a group on one machine and joins
  them by a deadline — what XLA's host-device flag gives the JAX tests.
  Rendezvous goes through a ``FileStore`` in a temporary directory or
  through torchrun: no fixed port.
* ``device`` (default ``"cuda"``) names where the mesh's ranks compute:
  without a card the default raises, as every entry point of the port
  does; ``"cpu"`` runs the ranks on the host (gloo).
* Each maker raises when the group's world size is not the product of
  the shape (JAX's ``make_mesh`` raises when the devices do not fill it).
* ``make_abstract_mesh`` has no counterpart: a ``DeviceMesh`` needs live
  ranks.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: how long a collective may wait before its group raises (seconds)
DEFAULT_TIMEOUT = 600.0


def init_sites(backend: str, *, store=None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               device: DeviceLike = "cuda",
               timeout: float = DEFAULT_TIMEOUT) -> int:
    """Join this process to the default process group; returns its rank.

    Without ``store`` the group comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); with one
    (a ``torch.distributed.Store``) ``rank`` and ``world_size`` are given
    here.  On ``device="cuda"`` the rank computes on card ``LOCAL_RANK``
    (torchrun) or ``rank`` modulo the cards: ranks beyond the cards share
    them, which NCCL refuses and gloo allows.  Every collective of the
    group raises after ``timeout`` seconds instead of waiting for ever.
    """
    dev = resolve_device(device)
    if store is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("init_sites(store=...) needs rank and world_size")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    elif backend == "nccl":
        raise ValueError("the nccl backend needs device='cuda'")
    dist.init_process_group(
        backend, store=store, rank=rank if store is not None else -1,
        world_size=world_size if store is not None else -1,
        timeout=datetime.timedelta(seconds=timeout))
    return dist.get_rank()


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device: DeviceLike = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, its
    dimensions named ``axes`` (rank ``r`` sits at ``r``'s row-major
    coordinates, as ``jax.make_mesh`` lays devices out)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_sites (or run "
                           "under torchrun) before making a mesh")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks, "
            f"the process group has {dist.get_world_size()}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda"):
    """JAX's production layouts: ``("data", "model")`` of 16 × 16 ranks, or
    ``("pod", "data", "model")`` of 2 × 16 × 16."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 4, model: int = 2, *,
                   device: DeviceLike = "cuda"):
    """A small ``("data", "model")`` mesh over one machine's ranks."""
    return make_mesh((data, model), ("data", "model"), device=device)


class SiteError(RuntimeError):
    """A rank of :func:`run_sites` raised, died or missed the deadline."""


def _site_main(fn, rank, world_size, backend, device, store_path, timeout,
               args, results) -> None:
    import faulthandler
    faulthandler.enable()               # a crashing rank says where
    try:
        store = dist.FileStore(store_path, world_size)
        init_sites(backend, store=store, rank=rank, world_size=world_size,
                   device=device, timeout=timeout)
        out = fn(rank, world_size, *args)
        results.put((rank, True, out))
    except BaseException:                   # noqa: BLE001 (sent to parent)
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_sites(fn: Callable, world_size: int, *, backend: str,
              device: DeviceLike = "cuda", timeout: float = DEFAULT_TIMEOUT,
              args: tuple = ()) -> List[object]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks and
    return their results, by rank.

    Each rank is a spawned process joined to one process group (``backend``
    on ``device``) through a ``FileStore`` in a temporary directory; ``fn``
    and its results must pickle.  The parent waits at most ``timeout``
    seconds in all — the group's collectives time out at the same bound, as
    a mismatched schedule hangs rather than fails — and raises
    :class:`SiteError` with the first failing rank's traceback, or when a
    rank dies silently or the deadline passes.  Every rank is stopped
    before it returns or raises.
    """
    resolve_device(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory(prefix="repro-sites-") as tmp:
        procs = [ctx.Process(
            target=_site_main, daemon=True,
            args=(fn, r, world_size, backend, device,
                  os.path.join(tmp, "store"), timeout, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise SiteError(
                        f"ranks {sorted(set(range(world_size)) - set(got))} "
                        f"did not finish within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        # a rank may have reported just before exiting
                        try:
                            rank, ok, payload = results.get(timeout=5.0)
                        except queue.Empty:
                            raise SiteError(
                                f"rank {dead[0]} exited with code "
                                f"{procs[dead[0]].exitcode} without a "
                                f"result") from None
                    else:
                        continue
                if not ok:
                    raise SiteError(f"rank {rank} of {world_size} failed:\n"
                                    f"{payload}")
                got[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10.0 if len(got) == world_size else 0.1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world_size)]
