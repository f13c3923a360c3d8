"""The paper's own benchmark CNNs (§V-A): AlexNet, VGG16, GoogleNet —
the same conv-layer shape tables as ``repro.configs.paper_cnns``, built
on the port's own :class:`~repro_torch.core.dataflow.ConvShape`.  Shapes
are the canonical published layer dims (Krizhevsky'12, Simonyan'14,
Szegedy'15)."""
from __future__ import annotations

from repro_torch.core.dataflow import ConvShape

# (M, N, RK, CK, RI, CI, stride) — RI/CI include any padding the nets use
ALEXNET = [
    ConvShape(96, 3, 11, 11, 227, 227, 4),
    ConvShape(256, 96, 5, 5, 31, 31, 1),
    ConvShape(384, 256, 3, 3, 15, 15, 1),
    ConvShape(384, 384, 3, 3, 15, 15, 1),
    ConvShape(256, 384, 3, 3, 15, 15, 1),
]

VGG16 = [
    ConvShape(64, 3, 3, 3, 226, 226, 1),
    ConvShape(64, 64, 3, 3, 226, 226, 1),
    ConvShape(128, 64, 3, 3, 114, 114, 1),
    ConvShape(128, 128, 3, 3, 114, 114, 1),
    ConvShape(256, 128, 3, 3, 58, 58, 1),
    ConvShape(256, 256, 3, 3, 58, 58, 1),
    ConvShape(256, 256, 3, 3, 58, 58, 1),
    ConvShape(512, 256, 3, 3, 30, 30, 1),
    ConvShape(512, 512, 3, 3, 30, 30, 1),
    ConvShape(512, 512, 3, 3, 30, 30, 1),
    ConvShape(512, 512, 3, 3, 16, 16, 1),
    ConvShape(512, 512, 3, 3, 16, 16, 1),
    ConvShape(512, 512, 3, 3, 16, 16, 1),
]

# GoogleNet: representative inception branch convs (3a–5b 3×3/5×5/1×1)
GOOGLENET = [
    ConvShape(64, 3, 7, 7, 229, 229, 2),
    ConvShape(192, 64, 3, 3, 58, 58, 1),
    ConvShape(128, 96, 3, 3, 30, 30, 1),
    ConvShape(192, 128, 3, 3, 30, 30, 1),
    ConvShape(208, 96, 3, 3, 16, 16, 1),
    ConvShape(224, 112, 3, 3, 16, 16, 1),
    ConvShape(256, 128, 3, 3, 16, 16, 1),
    ConvShape(288, 144, 3, 3, 16, 16, 1),
    ConvShape(320, 160, 3, 3, 16, 16, 1),
    ConvShape(384, 192, 3, 3, 9, 9, 1),
    ConvShape(48, 16, 5, 5, 32, 32, 1),
    ConvShape(128, 32, 5, 5, 18, 18, 1),
]

# GoogLeNet's inception modules, Szegedy et al. arXiv:1409.4842 Table 1:
# name -> (input plane, input channels, #1x1, #3x3 reduce, #3x3,
# #5x5 reduce, #5x5, pool proj); a module's output channels are
# #1x1 + #3x3 + #5x5 + pool proj, the next module's input.  A 3x3/2 max
# pooling comes after 3b and after 4e.
GOOGLENET_INCEPTION = {
    "3a": (28, 192, 64, 96, 128, 16, 32, 32),
    "3b": (28, 256, 128, 128, 192, 32, 96, 64),
    "4a": (14, 480, 192, 96, 208, 16, 48, 64),
    "4b": (14, 512, 160, 112, 224, 24, 64, 64),
    "4c": (14, 512, 128, 128, 256, 24, 64, 64),
    "4d": (14, 512, 112, 144, 288, 32, 64, 64),
    "4e": (14, 528, 256, 160, 320, 32, 128, 128),
    "5a": (7, 832, 256, 160, 320, 32, 128, 128),
    "5b": (7, 832, 384, 192, 384, 48, 128, 128),
}

PAPER_CNNS = {"alexnet": ALEXNET, "vgg16": VGG16, "googlenet": GOOGLENET}
