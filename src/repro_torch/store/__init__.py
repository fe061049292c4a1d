"""Out-of-core TRA execution: host-RAM relation store + plan streaming.

Port of ``repro.store``: the subsystem behind ``Engine(memory_budget=...)``
and ``HostRelation`` inputs — relations larger than the card's memory live
here as key-range blocks (page-locked where a card is present, with an
optional disk spill tier) and stream chunk-by-chunk through compiled plans,
each chunk's host→device copies on a side stream, overlapped with the
previous chunk's compute.
"""
from repro_torch.store.autotune import (chunk_slices, device_memory_budget,
                                        stream_budget_bytes)
from repro_torch.store.relation import (DEFAULT_BLOCK_BYTES, HostRelation,
                                        RelationStore, SpillCorruption,
                                        StoreError)
from repro_torch.store.stream import (NotStreamable, StreamExecutor,
                                      StreamPlan)

__all__ = [
    "DEFAULT_BLOCK_BYTES",
    "HostRelation",
    "NotStreamable",
    "RelationStore",
    "SpillCorruption",
    "StoreError",
    "StreamExecutor",
    "StreamPlan",
    "chunk_slices",
    "device_memory_budget",
    "stream_budget_bytes",
]
