"""Optimizer, learning-rate schedule and gradient compression of the LM
training path (the reference's ``optim/``)."""
from .adamw import adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
