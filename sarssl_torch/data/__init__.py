from .prefetch import device_prefetch
from .synthetic import SyntheticPairs, synth_batch

__all__ = ["SyntheticPairs", "synth_batch", "device_prefetch"]
