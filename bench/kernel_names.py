"""The yardstick's classes of device kernels, by name (frozen).  Nothing
here imports the program."""
import re

__all__ = ["CONV", "SMM_CONV", "CODR_MATMUL", "POOL"]

# convolution kernels: the port's smm_conv instances and cuDNN's
CONV = re.compile(r"smm_conv|fprop|implicit_gemm|implicit_convolve|"
                  r"conv2d|convolve|winograd|fft", re.I)
# the two smm_conv instances (sm90, simt)
SMM_CONV = re.compile(r"smm_conv(_sm90)?_kernel")
# the three codr_matmul instances (splitk, sm90, simt)
CODR_MATMUL = re.compile(r"codr_matmul(_splitk|_sm90)?_kernel")
# the 2x2 max pooling that the harness runs between a CNN's blocks
POOL = re.compile(r"max_pool", re.I)
