"""`repro_torch.train` — counterpart of `repro.train`: the training step
(`step`, one card or sharded over a mesh) and the compressed
data-parallel step (`dp`)."""
from .step import (TrainState, init_train_state, make_train_step,
                   model_loss, train_state_from_reference,
                   train_state_to_reference)

__all__ = ["TrainState", "make_train_step", "init_train_state",
           "model_loss", "train_state_from_reference",
           "train_state_to_reference"]
