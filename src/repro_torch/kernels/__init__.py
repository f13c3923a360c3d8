"""Hand-written Hopper kernels of the port, one package per TPU kernel
of ``repro.kernels`` (``smm_conv``, ``codr_matmul``, ``flash_attention``)
and one for the ``smm_kernel`` lane's feature path and epilogue, host
code in the reference (``int8_features``); each with the ``ops``
(wrapper) / ``ref`` (plain PyTorch version) split and its CUDA source
under ``csrc/``."""
