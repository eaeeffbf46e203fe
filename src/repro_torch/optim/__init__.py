"""`repro_torch.optim` — counterpart of `repro.optim`: functional
optimizers over the reference's leaves (`optimizers`) and the learning-
rate schedules (`schedule`)."""
from .optimizers import (Group, Optimizer, adafactor, adamw,
                         clip_by_global_norm, global_norm, make, sgd,
                         state_from_reference, state_to_reference)
from .schedule import cosine_schedule, linear_warmup

__all__ = ["Group", "Optimizer", "adamw", "adafactor", "sgd", "make",
           "global_norm", "clip_by_global_norm", "cosine_schedule",
           "linear_warmup", "state_to_reference", "state_from_reference"]
