"""Plain PyTorch version of the CoDR compressed matmul — the counterpart
of ``repro.kernels.codr_matmul.ref``: decode the packed indices through
the table, one float32 matmul, times the scale, cast to ``x``'s dtype.
The CPU path of :mod:`.ops` and the yardstick the CUDA kernel is held
to on the card."""
from __future__ import annotations

import torch

from repro_torch.core.codr_linear import unpack_unique

__all__ = ["decode_ref", "codr_matmul_ref"]


def decode_ref(packed: torch.Tensor, table: torch.Tensor, *, bits: int,
               n: int) -> torch.Tensor:
    """``(K, n·bits/32)`` int32 words → dense ``(K, n)`` float32 weights."""
    return unpack_unique(packed, table, bits=bits, n=n).to(torch.float32)


def codr_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                    table: torch.Tensor, scale: torch.Tensor, *, bits: int,
                    n: int) -> torch.Tensor:
    dense = decode_ref(packed, table, bits=bits, n=n)
    y = (x.to(torch.float32) @ dense) * scale
    return y.to(x.dtype)
