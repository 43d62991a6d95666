"""Launchers (counterparts of ``repro.launch``)."""
