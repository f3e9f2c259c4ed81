"""repro_torch.data — synthetic token streams and the taskflow prefetcher
(a numpy-only copy of ``repro.data``)."""
from .pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
