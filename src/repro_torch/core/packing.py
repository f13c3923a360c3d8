"""Bit-level packing utilities for the CoDR run-length encoder — the
port's NumPy copy of ``repro.core.packing``.

The CoDR RLE streams are true variable-width bitstreams (paper Fig. 4):
each field is ``flag_bit + payload`` where the payload is either the
low-precision width ``b`` or the full-precision width.  We implement an
exact bit-accurate packer/unpacker so compression ratios are measured in
real bits, not estimates.

Packing is fully vectorized (numpy).  Unpacking of variable-width streams
*looks* inherently sequential (the width of field ``k+1`` depends on the
flag bit of field ``k``), but because an escape-coded field takes only
two possible widths the field-start offsets of one stream form a jump
chain over the bit array that :func:`escape_field_offsets` resolves in
``O(log n)`` vectorized pointer-doubling passes, and many streams laid
back to back advance their cursors in lockstep
(:func:`escape_field_offsets_batch`); :func:`gather_bitfields` then
extracts every payload with shifts and masks in one pass.  The scalar
:class:`BitReader` is kept as the parity oracle.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "pack_varbits", "unpack_bits", "BitReader",
    "escape_field_offsets", "escape_field_offsets_batch", "gather_bitfields",
]


def pack_varbits(values: np.ndarray, widths: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack ``values[i]`` into ``widths[i]`` bits each, LSB-first per field.

    Returns ``(packed_uint8, total_bits)``.  Values must be non-negative and
    fit in their widths (masked to width — caller is responsible for
    two's-complement pre-encoding of negatives).
    """
    values = np.asarray(values, dtype=np.uint64)
    widths = np.asarray(widths, dtype=np.int64)
    if values.shape != widths.shape:
        raise ValueError(f"shape mismatch {values.shape} vs {widths.shape}")
    total_bits = int(widths.sum())
    if total_bits == 0:
        return np.zeros(0, dtype=np.uint8), 0
    # index of the source value for every output bit
    field_idx = np.repeat(np.arange(len(values)), widths)
    # bit position within each field (0 = LSB)
    offsets = np.cumsum(widths) - widths
    bitpos = np.arange(total_bits, dtype=np.int64) - np.repeat(offsets, widths)
    bits = ((values[field_idx] >> bitpos.astype(np.uint64)) & 1).astype(np.uint8)
    packed = np.packbits(bits, bitorder="little")
    return packed, total_bits


def unpack_bits(packed: np.ndarray, total_bits: int) -> np.ndarray:
    """Inverse of the bit-expansion in :func:`pack_varbits` — returns the raw
    0/1 bit array of length ``total_bits``."""
    bits = np.unpackbits(np.asarray(packed, dtype=np.uint8), bitorder="little")
    return bits[:total_bits]


# ---------------------------------------------------------------------------
# vectorized variable-width decode primitives
# ---------------------------------------------------------------------------

def escape_field_offsets(bits: np.ndarray, n_fields: int,
                         low_width: int, full_width: int) -> np.ndarray:
    """Start offsets of ``n_fields`` escape-coded fields in ``bits``.

    Field ``k`` starts at ``o_k``; its total width (flag + payload) is
    ``low_width`` when ``bits[o_k] == 0`` and ``full_width`` otherwise, so
    ``o_{k+1} = o_k + width(o_k)`` — a jump chain.  Resolved by pointer
    doubling: ``offsets[m:2m] = jump^m[offsets[:m]]``, composing the jump
    table with itself between blocks — ``O(|bits| · log n_fields)``
    vectorized work instead of a Python loop over fields.  Raises
    :class:`EOFError` when the last field starts past the end of ``bits``.
    """
    offsets = np.empty(n_fields, dtype=np.int64)
    if n_fields == 0:
        return offsets
    t = len(bits)
    pad = max(low_width, full_width, 1)          # safe gather past the end
    jump = np.arange(t + pad, dtype=np.int64)
    jump[:t] += np.where(bits[:t] == 0, low_width, full_width)
    np.minimum(jump, t + pad - 1, out=jump)
    offsets[0] = 0
    m = 1
    while m < n_fields:
        k = min(m, n_fields - m)
        offsets[m : m + k] = jump[offsets[:k]]
        m *= 2
        if m < n_fields:                         # compose: jump^m → jump^2m
            jump = np.minimum(jump[jump], t + pad - 1)
    if n_fields > 1 and offsets[-1] >= t:
        raise EOFError(
            f"bitstream exhausted resolving field offsets: field "
            f"{n_fields - 1} starts at bit {int(offsets[-1])} of {t}")
    return offsets


def escape_field_offsets_batch(bits: np.ndarray, starts: np.ndarray,
                               counts: np.ndarray, low_width: int,
                               full_width: int,
                               ends: np.ndarray | None = None) -> np.ndarray:
    """Field-start offsets for MANY escape streams laid back-to-back in
    ``bits`` (stream ``i`` starts at ``starts[i]`` and holds ``counts[i]``
    fields).  All stream cursors advance in lockstep — one vectorized
    gather per field *rank*, so the work is ``O(total_fields)`` regardless
    of how long the bit array is.

    ``ends`` — per-stream end offsets.  When given, each stream's final
    cursor must land EXACTLY on its end (field widths tile a valid payload
    with no slack), so a truncated or corrupt stream raises
    :class:`EOFError` instead of silently bleeding into its neighbour's
    bits — the same guarantee the scalar :class:`BitReader` gives.

    Returns the flat per-field offsets in stream-major order.
    """
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    out = np.empty(total, dtype=np.int64)
    if total == 0:
        return out
    dest_base = np.cumsum(counts) - counts
    order = np.argsort(-counts, kind="stable")   # longest streams first →
    counts_s = counts[order]                     # active set is a prefix
    cur = starts[order].copy()
    dest = dest_base[order]
    step = full_width - low_width
    try:
        for s in range(int(counts_s[0])):
            k = np.searchsorted(-counts_s, -s, side="left")
            c = cur[:k]
            out[dest[:k] + s] = c
            cur[:k] = c + low_width + step * bits[c]
    except IndexError:
        raise EOFError(
            f"bitstream exhausted resolving batch field offsets at rank "
            f"{s} of {int(counts_s[0])}") from None
    if ends is not None:
        bad = np.nonzero(cur != np.asarray(ends, dtype=np.int64)[order])[0]
        if len(bad):
            i = int(order[bad[0]])
            raise EOFError(
                f"corrupt stream {i}: {int(counts[i])} fields end at bit "
                f"{int(cur[bad[0]] - starts[i])} of its "
                f"{int(np.asarray(ends)[i] - starts[i])}-bit payload")
    return out


def gather_bitfields(bits: np.ndarray, offsets: np.ndarray,
                     widths: np.ndarray | int) -> np.ndarray:
    """Extract ``values[i]`` = the LSB-first ``widths[i]``-bit field starting
    at ``offsets[i]`` — one vectorized shift/mask pass, no cursor walk."""
    offsets = np.asarray(offsets, dtype=np.int64)
    widths = np.broadcast_to(np.asarray(widths, dtype=np.int64), offsets.shape)
    if len(offsets) == 0:
        return np.zeros(0, dtype=np.int64)
    w_max = int(widths.max())
    if w_max == 0:
        return np.zeros(len(offsets), dtype=np.int64)
    if len(bits) == 0 or int((offsets + widths).max()) > len(bits):
        raise EOFError(
            f"bitstream exhausted: field ends at bit "
            f"{int((offsets + widths).max())} of {len(bits)}")
    lanes = np.arange(w_max, dtype=np.int64)
    idx = np.minimum(offsets[:, None] + lanes, len(bits) - 1)
    lane_bits = bits[idx].astype(np.uint64) * (lanes < widths[:, None])
    return (lane_bits << lanes.astype(np.uint64)).sum(axis=1).astype(np.int64)


class BitReader:
    """Sequential cursor over a packed bitstream (LSB-first fields)."""

    def __init__(self, packed: np.ndarray, total_bits: int):
        self._bits = unpack_bits(packed, total_bits)
        self.pos = 0

    @property
    def remaining(self) -> int:
        return len(self._bits) - self.pos

    def read(self, width: int) -> int:
        if width == 0:
            return 0
        if self.pos + width > len(self._bits):
            raise EOFError(
                f"bitstream exhausted: read of {width} bits at position "
                f"{self.pos} overruns the {len(self._bits)}-bit payload")
        chunk = self._bits[self.pos : self.pos + width]
        self.pos += width
        # LSB-first
        return int((chunk.astype(np.uint64) << np.arange(width, dtype=np.uint64)).sum())

    def read_many(self, widths) -> np.ndarray:
        """Bulk read: ``out[i]`` is the next ``widths[i]``-bit field, in
        order.  One vectorized gather instead of ``len(widths)`` cursor
        steps; raises :class:`EOFError` (cursor unmoved) on overrun."""
        widths = np.asarray(widths, dtype=np.int64)
        if widths.ndim != 1:
            raise ValueError("widths must be a 1-D sequence")
        if len(widths) and widths.min() < 0:
            raise ValueError("widths must be non-negative")
        total = int(widths.sum())
        if self.pos + total > len(self._bits):
            raise EOFError(
                f"bitstream exhausted: bulk read of {total} bits at position "
                f"{self.pos} overruns the {len(self._bits)}-bit payload")
        offsets = self.pos + np.cumsum(widths) - widths
        out = gather_bitfields(self._bits, offsets, widths)
        self.pos += total
        return out
