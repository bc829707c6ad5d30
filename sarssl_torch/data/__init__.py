from .datasets import (FixMicSigDataset, FixMicSigDatasetLOCATA, OnTheFlyMicSigDataset,
                       RandomMixDataset, Segmenting, Selecting, batch_iterator, mp_batch_iterator)
from .device_synth import DeviceSynthConfig, synth_batch_device
from .prefetch import device_prefetch
from .rooms import MIC_ARRAY_2CH, AcousticSamplerConfig, sample_acoustic_scene
from .scene import SceneSynthesizer
from .shards import PackedDataset, is_packed, pack_dataset, pack_wav_tree
from .synthetic import SyntheticPairs, synth_batch, synth_batch_multich
from .wavio import audio_info, read_audio, read_wav, write_wav

__all__ = ["SyntheticPairs", "synth_batch", "synth_batch_multich", "device_prefetch",
           "read_wav", "write_wav", "read_audio", "audio_info",
           "AcousticSamplerConfig", "sample_acoustic_scene", "MIC_ARRAY_2CH", "SceneSynthesizer",
           "FixMicSigDataset", "FixMicSigDatasetLOCATA", "OnTheFlyMicSigDataset",
           "RandomMixDataset", "Segmenting", "Selecting", "batch_iterator", "mp_batch_iterator",
           "PackedDataset", "is_packed", "pack_dataset", "pack_wav_tree",
           "DeviceSynthConfig", "synth_batch_device"]
