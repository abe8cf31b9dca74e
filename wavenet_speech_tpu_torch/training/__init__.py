from wavenet_speech_tpu_torch.training.loss import JointLoss, next_signal_xe_loss
from wavenet_speech_tpu_torch.training.optimizer import (
    Optimizer,
    ReduceLROnPlateau,
    build_optimizer,
    make_lr_schedule,
)
from wavenet_speech_tpu_torch.training.trainer import (
    TrainState,
    make_eval_step,
    make_joint_train_step,
    param_tree,
)

__all__ = [
    "JointLoss",
    "next_signal_xe_loss",
    "Optimizer",
    "ReduceLROnPlateau",
    "build_optimizer",
    "make_lr_schedule",
    "TrainState",
    "make_joint_train_step",
    "make_eval_step",
    "param_tree",
]
