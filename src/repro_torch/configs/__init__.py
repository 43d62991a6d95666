from .base import ASSIGNED, ArchConfig, get, param_count, smoke  # noqa: F401
