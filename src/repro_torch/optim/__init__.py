"""Optimisers, LR schedule and gradient compression (counterparts of
``repro.optim``)."""
from .adamw import adamw  # noqa: F401
from .adafactor import adafactor  # noqa: F401
from .schedule import warmup_cosine  # noqa: F401
from .compress import error_feedback_compress, init_residual  # noqa: F401
