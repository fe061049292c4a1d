"""Which collectives gloo takes on CUDA tensors, on this machine's torch.

    python3 tools/gloo_cuda_probe.py          # on a machine with a card

Two ranks share ``cuda:0`` over gloo (one card cannot hold two NCCL
ranks).  Each rank tries ``all_reduce`` (SUM and MAX),
``all_gather_into_tensor``, ``all_to_all_single`` and
``reduce_scatter_tensor`` on CUDA tensors, checks the result against the
same collective computed by hand, and the parent prints one JSON line per
collective: ``{"op": ..., "cuda": true|false, "error": ...}``.  The
shard_map executor hands all four to gloo as they are
(``repro_torch.core.shardmap_exec.Exchange.run``): torch 2.11's gloo takes
them on an H100.  A torch whose gloo refuses one shows here first, and
the executor then needs a host-staged path for it.  Then DTensor's own
collectives over the gloo pair on CUDA tensors, each in a run of its own
(a crash ends only that run): ``Partial -> Replicate`` (an all-reduce) and
``full_tensor`` of a ``Shard(0)`` tensor (an all-gather) — the gspmd walk
stages them through the host when they fail
(``repro_torch.core.interp.redistribute``); and one rank alone over NCCL
runs ``all_reduce``.
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.mesh import SiteError, run_sites  # noqa: E402


def probe(rank: int, world: int) -> dict:
    dev = torch.device("cuda", 0)
    x = torch.arange(8.0, device=dev).reshape(4, 2) + rank
    want_sum = sum(torch.arange(8.0).reshape(4, 2) + r for r in range(world))
    cases = {
        "all_reduce(SUM)": lambda: (dist.all_reduce(t := x.clone()), t)[1],
        "all_reduce(MAX)": lambda: (dist.all_reduce(
            t := x.clone(), op=dist.ReduceOp.MAX), t)[1],
        "all_gather_into_tensor": lambda: (dist.all_gather_into_tensor(
            t := torch.empty(4 * world, 2, device=dev), x), t)[1],
        "all_to_all_single": lambda: (dist.all_to_all_single(
            t := torch.empty(4, 2, device=dev), x), t)[1],
        "reduce_scatter_tensor": lambda: (dist.reduce_scatter_tensor(
            t := torch.empty(4 // world, 2, device=dev), x), t)[1],
    }
    wants = {
        "all_reduce(SUM)": want_sum,
        "all_reduce(MAX)": torch.arange(8.0).reshape(4, 2) + world - 1,
        "all_gather_into_tensor": torch.cat(
            [torch.arange(8.0).reshape(4, 2) + r for r in range(world)]),
        "all_to_all_single": torch.cat(
            [(torch.arange(8.0).reshape(4, 2) + r)[rank * 4 // world:
                                                  (rank + 1) * 4 // world]
             for r in range(world)]),
        "reduce_scatter_tensor": want_sum[rank * 4 // world:
                                          (rank + 1) * 4 // world],
    }
    out = {}
    for name, fn in cases.items():
        try:
            got = fn()
            torch.cuda.synchronize(dev)
            out[name] = {"cuda": bool(torch.equal(got.cpu(), wants[name])),
                         "error": None}
        except Exception as err:            # noqa: BLE001 (a probe)
            out[name] = {"cuda": False, "error": f"{type(err).__name__}: "
                                                 f"{str(err)[:200]}"}
        dist.barrier()
    return out


def dtensor_case(rank: int, world: int, case: str) -> bool:
    """One of DTensor's collectives on CUDA tensors over the gloo group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("sites",))
    x = torch.arange(8.0, device="cuda").reshape(4, 2) + rank
    if case == "Partial->Replicate":
        d = DTensor.from_local(x, mesh, [Partial("sum")], run_check=False)
        got = d.redistribute(mesh, [Replicate()]).to_local()
        want = sum(torch.arange(8.0).reshape(4, 2) + r for r in range(world))
    else:
        got = DTensor.from_local(x, mesh, [Shard(0)],
                                 run_check=False).full_tensor()
        want = torch.cat([torch.arange(8.0).reshape(4, 2) + r
                          for r in range(world)])
    torch.cuda.synchronize()
    return bool(torch.equal(got.cpu(), want))


def nccl_one(rank: int, world: int) -> dict:
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return {"nccl world 1 all_reduce": bool(torch.equal(t.cpu(),
                                                       torch.ones(4)))}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}))
    results = run_sites(probe, 2, backend="gloo", device="cuda",
                        timeout=300)
    for name, res in results[0].items():
        print(json.dumps({"op": name, **res,
                          "rank1": results[1][name]["cuda"]}))
    for case in ("Partial->Replicate", "Shard(0).full_tensor"):
        try:
            ok = all(run_sites(dtensor_case, 2, backend="gloo",
                               device="cuda", timeout=120, args=(case,)))
            print(json.dumps({"op": f"dtensor {case}", "cuda": ok,
                              "error": None}))
        except SiteError as err:
            print(json.dumps({"op": f"dtensor {case}", "cuda": False,
                              "error": str(err).splitlines()[0]}))
    print(json.dumps(run_sites(nccl_one, 1, backend="nccl", device="cuda",
                               timeout=300)[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
