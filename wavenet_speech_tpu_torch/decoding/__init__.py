from wavenet_speech_tpu_torch.decoding.distributed import (distributed_beam_decode,
                                                           seq_sharded_beam_decode)

__all__ = ["distributed_beam_decode", "seq_sharded_beam_decode"]
