from wavenet_speech_tpu_torch.ops.activations import gated_activation, hardtanh, leaky_relu
from wavenet_speech_tpu_torch.ops.conv import (CausalConv1d, Conv1x1, Dense, NonCausalConv1d,
                                               autopad, causal_conv1d, noncausal_conv1d,
                                               receptive_field)
from wavenet_speech_tpu_torch.ops.ctc import (ctc_forward_logprob, ctc_loss, ctc_loss_flat,
                                              densify_labels)
from wavenet_speech_tpu_torch.ops.fns import compute_receptive_field, one_hot_encoding
from wavenet_speech_tpu_torch.ops.linear_conv import ker_ixs, linear_conv_step
from wavenet_speech_tpu_torch.ops.norm import LayerNorm

__all__ = ["CausalConv1d", "NonCausalConv1d", "Conv1x1", "Dense", "causal_conv1d",
           "noncausal_conv1d", "autopad", "receptive_field", "LayerNorm", "gated_activation",
           "leaky_relu", "hardtanh", "ctc_loss", "ctc_loss_flat", "densify_labels",
           "ctc_forward_logprob", "compute_receptive_field", "one_hot_encoding", "ker_ixs",
           "linear_conv_step"]
