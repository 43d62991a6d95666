"""Sentinels shared by the interpreter and the codegen emitters."""
from __future__ import annotations

POISON = object()  # kill-token sentinel in the store-value stream
