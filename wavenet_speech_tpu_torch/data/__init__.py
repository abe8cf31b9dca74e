"""The data layer (wavenet_speech_tpu/data/__init__.py's exports).

The exports are imported at first use (PEP 562), so importing one module of
the package, such as ``data.npz_loader`` in a spawned worker process, does
not import torch or the other loaders."""
import importlib

_EXPORTS = {
    "ALPHABET": "common", "Batch": "common", "MuLawQuantizer": "common",
    "one_hot_lc": "common", "interleave_zeros": "common",
    "PoreModelLoader": "pore_model", "DEFAULT_CURRENTS": "pore_model",
    "GaussianModelLoader": "gaussian_kmer", "RawGaussianModelLoader": "gaussian_kmer",
    "DEFAULT_KMER_MODEL": "gaussian_kmer", "kmer_ids": "gaussian_kmer",
    "RawSignalGenerator": "raw_signal",
    "QueueLoader": "hdf5", "BucketedLoader": "hdf5", "ecoli_worker_fn": "hdf5",
    "prefetch_to_device": "prefetch", "batch_to_device": "prefetch",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
