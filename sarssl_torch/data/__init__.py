from .synthetic import synth_batch

__all__ = ["synth_batch"]
