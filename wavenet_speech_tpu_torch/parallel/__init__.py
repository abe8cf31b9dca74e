"""The multi-device path on ``torch.distributed``
(wavenet_speech_tpu/parallel/): a (data, model, seq) mesh over the ranks,
data parallelism (DP), tensor parallelism (TP) as output-channel-sharded
params gathered at use (``parallel.sharding``), sequence parallelism (SP)
by halo exchange, and the sequence-sharded CTC.
"""
from wavenet_speech_tpu_torch.parallel.collectives import (
    all_reduce,
    batch_stats,
    gather_axis,
    psum,
)
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
from wavenet_speech_tpu_torch.parallel.sharding import (
    gather_params,
    param_shardings,
    shard_batch,
    shard_params,
)

__all__ = [
    "AXES",
    "Mesh",
    "make_mesh",
    "param_shardings",
    "shard_params",
    "gather_params",
    "shard_batch",
    "seq_axis",
    "current_seq_axis",
    "halo_pad",
    "seq_sharded_apply",
    "ctc_loss_seq_sharded",
    "all_reduce",
    "psum",
    "gather_axis",
    "batch_stats",
    "initialize_multihost",
    "is_primary",
    "local_batch_slice",
    "run_ranks",
]
