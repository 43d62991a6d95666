"""Training: the train step, the trainer, checkpoints and the fault
monitor (counterparts of ``repro.train``)."""
