from wavenet_speech_tpu_torch.models.blocks import (MultiplicativeUnit, ResidualBlock,
                                                    ResidualMUBlock, ResidualReLUBlock)
from wavenet_speech_tpu_torch.models.bytenet_decoder import ByteNetDecoder
from wavenet_speech_tpu_torch.models.classifier import WaveNetClassifier
from wavenet_speech_tpu_torch.models.conv_decoder import AttnConvolutionalDecoder
from wavenet_speech_tpu_torch.models.raw_ctcnet import RawCTCNet
from wavenet_speech_tpu_torch.models.rnn_decoder import RNNByteNetDecoder, StackedLSTMCell
from wavenet_speech_tpu_torch.models.stack import SkipSumStack
from wavenet_speech_tpu_torch.models.transformer import TransformerBasecaller
from wavenet_speech_tpu_torch.models.wavenet import WaveNet
from wavenet_speech_tpu_torch.models import fast_wavenet

__all__ = ["AttnConvolutionalDecoder", "ByteNetDecoder", "MultiplicativeUnit", "RawCTCNet",
           "ResidualBlock", "ResidualMUBlock", "ResidualReLUBlock", "RNNByteNetDecoder",
           "SkipSumStack", "StackedLSTMCell", "TransformerBasecaller", "WaveNet", "WaveNetClassifier", "fast_wavenet"]
