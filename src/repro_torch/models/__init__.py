"""The model stack of the port: layers, speculative MoE dispatch and the
dense and moe families' model builder (counterparts of ``repro.models``).
"""
