from wavenet_speech_tpu_torch.decoding.distributed import (distributed_beam_decode,
                                                           seq_sharded_beam_decode)
from wavenet_speech_tpu_torch.decoding.labelsync import Beam, BeamSearchDecoder

__all__ = ["Beam", "BeamSearchDecoder", "distributed_beam_decode", "seq_sharded_beam_decode"]
