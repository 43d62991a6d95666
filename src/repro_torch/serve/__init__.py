"""Serving: the batched engine and the traffic harness (counterparts of
``repro.serve``)."""
