"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
H100: cells of configurations under traffic mixes, driven through the
port's serving engine, held against a plain float32 reference.  Run
``python3 -m bench.run --help`` from the root of a checkout."""
