from .device import resolve_device
from .logging import MetricLogger, save_config
from .metrics import count_params
from .seeding import batch_generator, epoch_generator, set_seed, step_generator
from .weights import flax_tree, from_jax_params, to_jax_params

__all__ = ["resolve_device", "from_jax_params", "to_jax_params", "flax_tree", "MetricLogger",
           "save_config", "count_params", "set_seed", "epoch_generator", "batch_generator",
           "step_generator"]
