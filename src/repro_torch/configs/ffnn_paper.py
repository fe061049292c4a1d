"""The paper's own §5.3 two-layer FFNN benchmark configs.

Google-speech: D=1600 features, L=10 labels, H ∈ {100k, 150k, 200k},
minibatch N=10^4.  AmazonCat-14k extreme classification: D=597540,
L=14588, H ∈ {1k,3k,5k,7k}, minibatch N=10^3.  These are not decoder LMs;
they drive the TRA-DP vs TRA-MP plan comparison in benchmarks/ffnn.py.

A copy of ``repro.configs.ffnn_paper`` (the port imports nothing of
``repro``).  ``speech(100_000)`` is the width the port serves on the card.
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FFNNConfig:
    name: str
    d_in: int
    d_hidden: int
    d_out: int
    batch: int
    lr: float = 0.01


def speech(hidden: int) -> FFNNConfig:
    return FFNNConfig(f"speech-{hidden // 1000}k", 1_600, hidden, 10, 10_000)


def amazoncat(hidden: int) -> FFNNConfig:
    return FFNNConfig(f"xml-{hidden // 1000}k", 597_540, hidden, 14_588,
                      1_000)


SPEECH_GRID: Tuple[FFNNConfig, ...] = tuple(
    speech(h) for h in (100_000, 150_000, 200_000))
XML_GRID: Tuple[FFNNConfig, ...] = tuple(
    amazoncat(h) for h in (1_000, 3_000, 5_000, 7_000))

SMOKE = FFNNConfig("ffnn-smoke", 32, 64, 8, 16)
