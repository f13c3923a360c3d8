"""UCNN weight compression (paper §V-B) — the port's copy of
``repro.core.baselines.ucnn`` (pure NumPy).

"UCNN employs RLE to compress the weights and indexes, yet, it uses
bit-length of 5 for all layers. UCNN additionally appends 1 bit to each
index to indicate the transition to a new unique weight."

So: the same escape-coded Δ streams as CoDR but with the encoding
parameter *fixed at 5* (no per-layer search), no repetition-count stream
(group boundaries are marked by the per-index transition bit instead),
applied to the same UCR factorization (UCNN exploits repetition and
sparsity but not similarity — Δs are an encoding detail for it, not a
compute saving)."""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import rle
from repro_torch.core.ucr import UCRVector

__all__ = ["ucnn_vector_bits", "ucnn_compress_bits"]

FIXED_BITS = 5


def ucnn_vector_bits(u: UCRVector) -> int:
    index_bits = max(1, math.ceil(math.log2(max(u.vector_len, 2))))
    deltas = rle.delta_transform(u.unique_vals)
    weight_bits = rle.escape_stream_bits(deltas, FIXED_BITS, rle.FULL_BITS)
    idx_deltas, _ = rle.index_delta_fields(u.indexes)
    idx_bits = rle.escape_stream_bits(
        idx_deltas, min(FIXED_BITS, index_bits), index_bits)
    transition_bits = len(u.indexes)             # 1 bit per index
    return weight_bits + idx_bits + transition_bits


def ucnn_compress_bits(vectors: list[UCRVector]) -> int:
    # no per-layer parameter header — UCNN's bit-length is globally fixed
    return sum(ucnn_vector_bits(u) for u in vectors)
