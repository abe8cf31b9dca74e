from wavenet_speech_tpu_torch.data.common import (ALPHABET, Batch, MuLawQuantizer,
                                                  interleave_zeros, one_hot_lc)
from wavenet_speech_tpu_torch.data.gaussian_kmer import (DEFAULT_KMER_MODEL,
                                                         GaussianModelLoader,
                                                         RawGaussianModelLoader, kmer_ids)
from wavenet_speech_tpu_torch.data.hdf5 import BucketedLoader, QueueLoader, ecoli_worker_fn
from wavenet_speech_tpu_torch.data.pore_model import DEFAULT_CURRENTS, PoreModelLoader
from wavenet_speech_tpu_torch.data.prefetch import batch_to_device, prefetch_to_device
from wavenet_speech_tpu_torch.data.raw_signal import RawSignalGenerator

__all__ = ["ALPHABET", "Batch", "MuLawQuantizer", "one_hot_lc", "interleave_zeros",
           "PoreModelLoader", "DEFAULT_CURRENTS", "GaussianModelLoader",
           "RawGaussianModelLoader", "DEFAULT_KMER_MODEL", "kmer_ids", "RawSignalGenerator",
           "QueueLoader", "BucketedLoader", "ecoli_worker_fn", "prefetch_to_device",
           "batch_to_device"]
