from .features import FeatureConfig, stft_features
from .mask import (T1S_MODE, T_MODE, TCLUSTER2_MODE, TCLUSTER_INV_MODE, TCLUSTER_MODE, TF_MODE,
                   PatchMask, gen_patch_mask)
from .pairs import mic_pair_rebatch, num_pairs, pair_unbatch, pairwise_tdoa
from .patches import patch_recover, patch_split
from .stft import frame_signal, hann_window, istft, overlap_add, stft

__all__ = ["FeatureConfig", "stft_features", "PatchMask", "gen_patch_mask", "T_MODE",
           "T1S_MODE", "TCLUSTER_MODE", "TCLUSTER_INV_MODE", "TCLUSTER2_MODE", "TF_MODE",
           "mic_pair_rebatch", "num_pairs", "pair_unbatch", "pairwise_tdoa", "patch_split",
           "patch_recover", "frame_signal", "hann_window", "stft", "istft", "overlap_add"]
