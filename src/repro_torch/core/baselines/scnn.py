"""SCNN weight compression (paper §V-B) — the port's copy of
``repro.core.baselines.scnn`` (pure NumPy).

"SCNN does not compress the non-zero weights and stores the number of
zero values between two subsequent non-zero weights in 4 bits."  When a
zero-run exceeds 15 a zero-valued placeholder weight is inserted (the
standard SCNN escape)."""
from __future__ import annotations

import numpy as np

__all__ = ["scnn_compress_bits"]

RUN_BITS = 4
WEIGHT_BITS = 8
MAX_RUN = (1 << RUN_BITS) - 1


def scnn_compress_bits(q: np.ndarray) -> int:
    """Encoded size in bits of an int8 weight tensor under SCNN's scheme."""
    flat = np.asarray(q).reshape(-1)
    nz = np.nonzero(flat)[0]
    if len(nz) == 0:
        return WEIGHT_BITS + RUN_BITS  # single placeholder
    runs = np.diff(nz, prepend=-1) - 1           # zeros before each nonzero
    # placeholders for overflowing runs: each covers MAX_RUN zeros + a
    # zero weight entry
    placeholders = int((runs // (MAX_RUN + 1)).sum())
    n_entries = len(nz) + placeholders
    return n_entries * (WEIGHT_BITS + RUN_BITS)
