"""Hand-written Hopper kernels of the port, one package per TPU kernel
of ``repro.kernels``, each with the ``ops`` (wrapper) / ``ref`` (plain
PyTorch version) split and its CUDA source under ``csrc/``."""
