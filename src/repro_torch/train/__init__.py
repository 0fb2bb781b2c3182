"""Training, eval and serving steps (port of ``repro.train``): AdamW, the
cosine schedule, the token pipeline, checkpoints, gradient compression and
the step factories."""
from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.train.schedule import cosine_schedule
from repro_torch.train.step import make_eval_step, make_train_step

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "make_train_step",
    "make_eval_step",
]
