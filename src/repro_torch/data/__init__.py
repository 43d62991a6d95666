"""The data pipeline (counterpart of ``repro.data``)."""
