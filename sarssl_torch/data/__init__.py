from .prefetch import device_prefetch
from .synthetic import SyntheticPairs, synth_batch, synth_batch_multich

__all__ = ["SyntheticPairs", "synth_batch", "synth_batch_multich", "device_prefetch"]
