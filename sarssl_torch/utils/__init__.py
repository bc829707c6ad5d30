from .device import resolve_device
from .weights import from_jax_params

__all__ = ["resolve_device", "from_jax_params"]
