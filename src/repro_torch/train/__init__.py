"""AdamW with int8 moments, the LR schedules and the train / serve step
factories (counterpart of ``repro.train``)."""
from .optimizer import adamw, make_schedule
from .trainstep import make_serve_step, make_train_step

__all__ = ["adamw", "make_schedule", "make_train_step", "make_serve_step"]
