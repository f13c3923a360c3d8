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

PAPER_CNNS = {"alexnet": ALEXNET, "vgg16": VGG16, "googlenet": GOOGLENET}
