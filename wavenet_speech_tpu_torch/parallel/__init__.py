"""The multi-device path on ``torch.distributed``
(wavenet_speech_tpu/parallel/): a (data, model, seq) mesh over the ranks,
data parallelism (DP), sequence parallelism (SP) by halo exchange, and the
sequence-sharded CTC. Tensor parallelism (the "model" axis) is not ported.
"""
from wavenet_speech_tpu_torch.parallel.ctc_sharded import ctc_loss_seq_sharded
from wavenet_speech_tpu_torch.parallel.distributed import (
    initialize_multihost,
    is_primary,
    local_batch_slice,
)
from wavenet_speech_tpu_torch.parallel.halo import (
    current_seq_axis,
    halo_pad,
    seq_axis,
    seq_sharded_apply,
)
from wavenet_speech_tpu_torch.parallel.launch import run_ranks
from wavenet_speech_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh
from wavenet_speech_tpu_torch.parallel.sharding import shard_batch, shard_params

__all__ = [
    "AXES",
    "Mesh",
    "make_mesh",
    "shard_params",
    "shard_batch",
    "seq_axis",
    "current_seq_axis",
    "halo_pad",
    "seq_sharded_apply",
    "ctc_loss_seq_sharded",
    "initialize_multihost",
    "is_primary",
    "local_batch_slice",
    "run_ranks",
]
