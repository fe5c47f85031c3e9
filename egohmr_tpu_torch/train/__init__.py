"""Training: stage 2's step (`loop.py`) and CLI (`train_egohmr.py`), stage
1's GAN step (`prohmr_loop.py`) and CLI (`train_prohmr.py`), and the
distillation CLIs of the learned collision nets (`distill_occupancy.py`,
`distill_sdf.py`)."""
from .loop import (
    TrainConfig,
    gt_pose_to_x_start,
    make_optimizer,
    make_train_step,
    stage2_loss,
    trainable_tensors,
)
from .prohmr_loop import (
    discriminator_loss,
    generator_loss,
    make_optimizers,
    make_prohmr_train_step,
)

__all__ = ["TrainConfig", "discriminator_loss", "generator_loss", "gt_pose_to_x_start",
           "make_optimizer", "make_optimizers", "make_prohmr_train_step", "make_train_step",
           "stage2_loss", "trainable_tensors"]
