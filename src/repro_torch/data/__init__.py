from repro_torch.data.pipeline import DataConfig, DataLoader, make_batch

__all__ = ["DataConfig", "DataLoader", "make_batch"]
