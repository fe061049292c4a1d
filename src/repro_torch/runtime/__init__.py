"""The model zoo's training runtime on one card (``repro.runtime``
counterpart, less ``gpipe`` and ``elastic_restore``: ROADMAP A7.2b)."""
from repro_torch.runtime.pipeline import bubble_fraction
from repro_torch.runtime.trainer import (SimulatedFailure, StragglerMonitor,
                                         Trainer, TrainerConfig,
                                         make_train_step)

__all__ = ["bubble_fraction", "SimulatedFailure", "StragglerMonitor",
           "Trainer", "TrainerConfig", "make_train_step"]
