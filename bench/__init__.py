"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a harness
driven by data.  ``python3 -m bench.run --help``; ``harness`` says where
each piece lives."""
