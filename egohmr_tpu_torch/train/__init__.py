"""Stage-2 training: the step (`loop.py`) and the CLI (`train_egohmr.py`)."""
from .loop import (
    TrainConfig,
    gt_pose_to_x_start,
    make_optimizer,
    make_train_step,
    stage2_loss,
    trainable_tensors,
)

__all__ = ["TrainConfig", "gt_pose_to_x_start", "make_optimizer", "make_train_step",
           "stage2_loss", "trainable_tensors"]
