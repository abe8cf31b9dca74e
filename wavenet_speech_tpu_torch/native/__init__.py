from wavenet_speech_tpu_torch.native.ctc_beam import (
    build_error,
    ctc_beam_search_native,
    native_available,
)

__all__ = ["build_error", "ctc_beam_search_native", "native_available"]
