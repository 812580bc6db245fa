"""Data sources for training, in numpy (counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import MemmapLM, Prefetcher, SyntheticLM

__all__ = ["MemmapLM", "Prefetcher", "SyntheticLM"]
