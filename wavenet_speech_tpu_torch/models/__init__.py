from wavenet_speech_tpu_torch.models.blocks import ResidualBlock
from wavenet_speech_tpu_torch.models.classifier import WaveNetClassifier
from wavenet_speech_tpu_torch.models.raw_ctcnet import RawCTCNet
from wavenet_speech_tpu_torch.models.stack import SkipSumStack
from wavenet_speech_tpu_torch.models.wavenet import WaveNet

__all__ = ["RawCTCNet", "ResidualBlock", "SkipSumStack", "WaveNet", "WaveNetClassifier"]
