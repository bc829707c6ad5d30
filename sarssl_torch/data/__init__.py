from .prefetch import device_prefetch
from .synthetic import SyntheticPairs, synth_batch, synth_batch_multich
from .wavio import audio_info, read_audio, read_wav, write_wav

__all__ = ["SyntheticPairs", "synth_batch", "synth_batch_multich", "device_prefetch",
           "read_wav", "write_wav", "read_audio", "audio_info"]
