"""Customized Run-Length Encoding (paper §III-C, Fig. 4).

The port's own copy of ``repro.core.rle``: pure NumPy, byte-identical
streams.  CoDR stores three data structures per weight vector (one
vector = the weights of one input channel across a T_M-output-channel
tile, paper §II-D step iii):

  (a) **Unique-weight Δs** — differences between successive *sorted*
      non-zero unique weights (the first entry is the smallest unique
      weight biased by +128).  Encoded as ``b`` low-precision bits + 1
      escape bit; values that do not fit fall back to 8 bits.
  (b) **Repetition counts** — fixed ``b``-bit fields storing ``count-1``;
      on overflow a *dummy unique weight with Δ=0* carries the remainder.
  (c) **Indexes** — output indexes of every repetition, Δ-coded with the
      same escape scheme; the fallback is the *absolute* index.

The encoder searches each structure's bit-length per layer (§III-C).
:func:`decode_vector` is the scalar oracle: it reads one field at a time
with a :class:`~repro_torch.core.packing.BitReader` and rebuilds the
vector with Python loops, independent of the bulk path;
:func:`decode_layer` decodes a whole layer in one vectorized pass and is
held to the oracle.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.packing import (BitReader, escape_field_offsets_batch,
                                      gather_bitfields, pack_varbits)

__all__ = [
    "FULL_BITS", "HEADER_BITS", "Stream", "EncodedVector", "encode_vector",
    "decode_vector", "decode_escape_stream", "decode_rep_stream",
    "decode_layer", "decode_layer_vectors", "layer_params_search",
    "layer_bits_size_only", "encoded_bits_size_only", "delta_transform",
    "delta_untransform_first", "escape_stream_bits", "index_delta_fields",
]

FULL_BITS = 8            # full-precision fallback width for int8 weight deltas
HEADER_BITS = 32         # per-stream header: 4b param + 28b count (modelled)
PARAM_SEARCH_SPACE = range(1, 9)


@dataclasses.dataclass
class Stream:
    """One encoded RLE stream."""

    packed: np.ndarray       # uint8 payload
    nbits: int               # exact payload bits
    param: int               # chosen low-precision bit-length
    count: int               # number of fields
    mode_bits: int           # width of the absolute/full-precision fallback

    @property
    def total_bits(self) -> int:
        return self.nbits + HEADER_BITS


@dataclasses.dataclass
class EncodedVector:
    """All three streams for one UCR weight vector + metadata."""

    deltas: Stream
    reps: Stream
    indexes: Stream
    vector_len: int          # T_M * R_K * C_K (index space)
    n_unique: int            # unique non-zero weights incl. overflow dummies
    n_weights: int           # non-zero weight count (== number of indexes)

    @property
    def total_bits(self) -> int:
        return self.deltas.total_bits + self.reps.total_bits + self.indexes.total_bits


# ---------------------------------------------------------------------------
# escape-coded streams (Δs and indexes)
# ---------------------------------------------------------------------------

def _escape_fields(values: np.ndarray, low_bits: int, full_bits: int,
                   absolute: np.ndarray | None = None):
    """``(field_values, field_widths, fits)``: each field is a flag bit
    (0 = low precision, 1 = escape) followed by its payload.  With
    ``absolute`` (index stream) escaped values carry the absolute value
    instead of their Δ."""
    values = np.asarray(values, dtype=np.int64)
    fits = (values >= 0) & (values < (1 << low_bits))
    if absolute is not None:
        payload = np.where(fits, values, absolute)
    else:
        # two's complement into full_bits for negatives / overflow
        payload = np.where(fits, values, values & ((1 << full_bits) - 1))
    widths = np.where(fits, low_bits, full_bits)
    fields = (payload.astype(np.uint64) << np.uint64(1)) | (~fits).astype(np.uint64)
    return fields, widths + 1, fits


def escape_stream_bits(values: np.ndarray, low_bits: int, full_bits: int) -> int:
    """Size of an escape stream without materializing it (the search)."""
    values = np.asarray(values, dtype=np.int64)
    fits = (values >= 0) & (values < (1 << low_bits))
    return int(np.where(fits, low_bits + 1, full_bits + 1).sum())


def encode_escape_stream(values: np.ndarray, low_bits: int, full_bits: int,
                         absolute: np.ndarray | None = None) -> Stream:
    fields, widths, _ = _escape_fields(values, low_bits, full_bits, absolute)
    packed, nbits = pack_varbits(fields, widths)
    return Stream(packed, nbits, low_bits, len(values), full_bits)


def decode_escape_stream(stream: Stream, *, absolute_mode: bool = False) -> np.ndarray:
    """Decode an escape stream one field at a time: int64 ``(count,)``
    payloads (unsigned — Δ streams are pre-biased, see
    :func:`delta_transform`).  With ``absolute_mode`` the result is
    ``(2, count)``: the payloads and the escape flags (1 = escaped), to
    rebuild a mixed Δ/absolute position sequence."""
    reader = BitReader(stream.packed, stream.nbits)
    out = np.empty(stream.count, dtype=np.int64)
    escaped = np.zeros(stream.count, dtype=bool)
    for i in range(stream.count):
        if reader.read(1):
            out[i] = reader.read(stream.mode_bits)
            escaped[i] = True
        else:
            out[i] = reader.read(stream.param)
    return out if not absolute_mode else np.stack([out, escaped.astype(np.int64)])


# ---------------------------------------------------------------------------
# fixed-width repetition-count stream
# ---------------------------------------------------------------------------

def split_rep_overflow(reps: np.ndarray, rep_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """Split counts that overflow ``rep_bits`` into chains of entries.
    Returns ``(rep_entries, dummy_mask)``; dummies carry Δ = 0.  Each
    entry covers counts in ``[1, 2**rep_bits]``."""
    cap = 1 << rep_bits
    reps = np.asarray(reps, dtype=np.int64)
    n_entries = np.maximum(1, np.ceil(reps / cap)).astype(np.int64)
    total = int(n_entries.sum())
    entries = np.full(total, cap, dtype=np.int64)
    dummy = np.ones(total, dtype=bool)
    starts = np.cumsum(n_entries) - n_entries
    ends = starts + n_entries - 1
    leftover = reps - (n_entries - 1) * cap
    entries[ends] = leftover
    dummy[starts] = False
    return entries, dummy


def rep_stream_bits(reps: np.ndarray, rep_bits: int, delta_cost_bits: float) -> float:
    """Repetition-stream size including the Δ fields its dummies add."""
    cap = 1 << rep_bits
    reps = np.asarray(reps, dtype=np.int64)
    n_entries = np.maximum(1, np.ceil(reps / cap)).astype(np.int64)
    n_dummies = int(n_entries.sum()) - len(reps)
    return float(int(n_entries.sum()) * rep_bits + n_dummies * delta_cost_bits)


def encode_rep_stream(entries: np.ndarray, rep_bits: int) -> Stream:
    entries = np.asarray(entries, dtype=np.int64)
    fields = (entries - 1).astype(np.uint64)          # store count-1
    widths = np.full(len(entries), rep_bits, dtype=np.int64)
    packed, nbits = pack_varbits(fields, widths)
    return Stream(packed, nbits, rep_bits, len(entries), rep_bits)


def decode_rep_stream(stream: Stream) -> np.ndarray:
    """Decode a repetition stream one field at a time: int64 counts."""
    reader = BitReader(stream.packed, stream.nbits)
    return np.array([reader.read(stream.param) + 1 for _ in range(stream.count)],
                    dtype=np.int64)


# ---------------------------------------------------------------------------
# full vector encode / scalar decode
# ---------------------------------------------------------------------------

def delta_transform(unique_vals: np.ndarray) -> np.ndarray:
    """Sorted unique int8 values → non-negative Δ fields: the first is
    the smallest value biased by +128 (∈ [1, 255]), the rest are the
    strictly positive Δs (∈ [1, 254])."""
    unique_vals = np.asarray(unique_vals, dtype=np.int64)
    out = np.empty(len(unique_vals), dtype=np.int64)
    if len(out):
        out[0] = unique_vals[0] + 128
        out[1:] = np.diff(unique_vals)
    return out


def delta_untransform_first(field: int) -> int:
    """Inverse of the first field's +128 bias (:func:`delta_transform`)."""
    return field - 128


def index_delta_fields(indexes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Δ between subsequent indexes; the first index (and any negative
    Δ) escapes to its absolute value."""
    indexes = np.asarray(indexes, dtype=np.int64)
    deltas = np.empty_like(indexes)
    if len(indexes):
        deltas[0] = -1                        # force absolute for the first
        deltas[1:] = indexes[1:] - indexes[:-1]
    return deltas, indexes


def search_delta_param(deltas: np.ndarray) -> int:
    sizes = {b: escape_stream_bits(deltas, b, FULL_BITS) for b in PARAM_SEARCH_SPACE}
    return min(sizes, key=sizes.get)


def search_index_param(index_deltas: np.ndarray, index_bits: int) -> int:
    space = [b for b in PARAM_SEARCH_SPACE if b <= index_bits] or [index_bits]
    sizes = {b: escape_stream_bits(index_deltas, b, index_bits) for b in space}
    return min(sizes, key=sizes.get)


def search_rep_param(reps: np.ndarray, delta_cost_bits: float) -> int:
    sizes = {b: rep_stream_bits(reps, b, delta_cost_bits) for b in PARAM_SEARCH_SPACE}
    return min(sizes, key=sizes.get)


def encode_vector(unique_vals: np.ndarray, reps: np.ndarray,
                  indexes: np.ndarray, vector_len: int,
                  params: tuple[int, int, int] | None = None
                  ) -> EncodedVector:
    """Encode one UCR-transformed weight vector (:mod:`repro_torch.core.ucr`).

    ``params`` — optional (delta, rep, index) bit-lengths shared across a
    layer (:func:`layer_params_search`); ``None`` searches per vector.
    """
    unique_vals = np.asarray(unique_vals, dtype=np.int64)
    reps = np.asarray(reps, dtype=np.int64)
    indexes = np.asarray(indexes, dtype=np.int64)
    index_bits = max(1, math.ceil(math.log2(max(vector_len, 2))))

    base_deltas = delta_transform(unique_vals)
    if params is not None:
        delta_param, rep_param, index_param_fixed = params
    else:
        delta_param = search_delta_param(base_deltas)
        delta_cost = escape_stream_bits(base_deltas, delta_param,
                                        FULL_BITS) / max(len(base_deltas), 1)
        rep_param = search_rep_param(reps, delta_cost)
        index_param_fixed = None

    rep_entries, dummy = split_rep_overflow(reps, rep_param)
    full_deltas = np.zeros(len(rep_entries), dtype=np.int64)
    full_deltas[~dummy] = base_deltas

    idx_deltas, idx_abs = index_delta_fields(indexes)
    index_param = (index_param_fixed if index_param_fixed is not None
                   else search_index_param(idx_deltas, index_bits))
    index_param = min(index_param, index_bits)

    deltas_s = encode_escape_stream(full_deltas, delta_param, FULL_BITS)
    reps_s = encode_rep_stream(rep_entries, rep_param)
    indexes_s = encode_escape_stream(idx_deltas, index_param, index_bits,
                                     absolute=idx_abs)
    return EncodedVector(deltas_s, reps_s, indexes_s, vector_len,
                         len(rep_entries), len(indexes))


def decode_vector(enc: EncodedVector) -> np.ndarray:
    """The scalar oracle: rebuild the dense int8 weight vector
    (``(vector_len,)``) from its three streams, one field and one weight
    at a time (inverse of UCR + RLE)."""
    deltas = decode_escape_stream(enc.deltas)
    reps = decode_rep_stream(enc.reps)
    vals, escaped = decode_escape_stream(enc.indexes, absolute_mode=True)
    # absolute indexes from the Δ/absolute mix
    indexes = np.empty(enc.indexes.count, dtype=np.int64)
    prev = 0
    for i in range(enc.indexes.count):
        indexes[i] = vals[i] if escaped[i] else prev + vals[i]
        prev = indexes[i]

    weights = np.zeros(enc.vector_len, dtype=np.int8)
    running = 0
    cursor = 0
    for u in range(enc.n_unique):
        if u == 0:
            running = delta_untransform_first(int(deltas[0]))
        else:
            running += int(deltas[u])
        for _ in range(int(reps[u])):
            weights[indexes[cursor]] = running
            cursor += 1
    return weights


# ---------------------------------------------------------------------------
# vectorized bulk decode — whole layer, no per-field Python loop
# ---------------------------------------------------------------------------

def _stream_bits(streams) -> tuple[np.ndarray, np.ndarray]:
    """Bit-level concatenation of many packed streams, dropping each
    stream's byte-alignment slack.  Returns ``(bits, stream_bit_starts)``."""
    allbits = np.unpackbits(
        np.concatenate([np.asarray(s.packed, dtype=np.uint8)
                        for s in streams]) if streams
        else np.zeros(0, dtype=np.uint8), bitorder="little")
    nbytes = np.array([len(s.packed) for s in streams], dtype=np.int64)
    nbits = np.array([s.nbits for s in streams], dtype=np.int64)
    starts = np.cumsum(nbits) - nbits
    within = (np.arange(int(nbits.sum()), dtype=np.int64)
              - np.repeat(starts, nbits))
    idx = np.repeat((np.cumsum(nbytes) - nbytes) * 8, nbits) + within
    return allbits[idx], starts


def _flat_dest(field_start: np.ndarray, counts: np.ndarray,
               idxs: list[int]) -> np.ndarray:
    """Flat positions of the fields of streams ``idxs`` in stream-major
    all-streams field order."""
    sub_counts = counts[idxs]
    total = int(sub_counts.sum())
    within = (np.arange(total, dtype=np.int64)
              - np.repeat(np.cumsum(sub_counts) - sub_counts, sub_counts))
    return np.repeat(field_start[idxs], sub_counts) + within


def _grouped_escape_decode(streams) -> tuple[np.ndarray, np.ndarray]:
    """Decode many escape streams, one vectorized pass per
    ``(param, mode_bits)`` group.  Returns ``(values, escaped)``."""
    counts = np.array([s.count for s in streams], dtype=np.int64)
    total = int(counts.sum())
    values = np.zeros(total, dtype=np.int64)
    escaped = np.zeros(total, dtype=bool)
    if total == 0:
        return values, escaped
    field_start = np.cumsum(counts) - counts
    groups: dict[tuple[int, int], list[int]] = {}
    for si, s in enumerate(streams):
        if s.count:
            groups.setdefault((s.param, s.mode_bits), []).append(si)
    for (param, mode), idxs in groups.items():
        bits, starts = _stream_bits([streams[i] for i in idxs])
        ends = starts + np.array([streams[i].nbits for i in idxs],
                                 dtype=np.int64)
        offsets = escape_field_offsets_batch(bits, starts, counts[idxs],
                                             param + 1, mode + 1, ends)
        flags = bits[offsets].astype(bool)
        vals = gather_bitfields(bits, offsets + 1,
                                np.where(flags, mode, param))
        dest = _flat_dest(field_start, counts, idxs)
        values[dest] = vals
        escaped[dest] = flags
    return values, escaped


def _grouped_rep_decode(streams) -> np.ndarray:
    """Decode many fixed-width repetition streams, one gather per
    ``rep_bits`` group."""
    counts = np.array([s.count for s in streams], dtype=np.int64)
    total = int(counts.sum())
    out = np.zeros(total, dtype=np.int64)
    if total == 0:
        return out
    field_start = np.cumsum(counts) - counts
    groups: dict[int, list[int]] = {}
    for si, s in enumerate(streams):
        if s.count:
            groups.setdefault(s.param, []).append(si)
    for param, idxs in groups.items():
        bits, starts = _stream_bits([streams[i] for i in idxs])
        nbits = np.array([streams[i].nbits for i in idxs], dtype=np.int64)
        short = np.nonzero(counts[idxs] * param != nbits)[0]
        if len(short):                       # truncated/corrupt rep stream
            i = idxs[int(short[0])]
            raise EOFError(
                f"corrupt rep stream {i}: {int(counts[i])} x {param}-bit "
                f"fields vs a {int(streams[i].nbits)}-bit payload")
        within = _flat_dest(np.zeros_like(field_start), counts, idxs)
        offsets = np.repeat(starts, counts[idxs]) + within * param
        vals = gather_bitfields(bits, offsets, param) + 1
        out[_flat_dest(field_start, counts, idxs)] = vals
    return out


def decode_layer(code, *, pad_to: int | None = None) -> np.ndarray:
    """Decode every vector of a :class:`repro_torch.core.ucr.LayerCode`
    (or a plain sequence of :class:`EncodedVector`) in one vectorized
    pass.  Returns int8 ``(n_vectors, pad_to)``, each row zero-padded
    (default: the layer's max ``vector_len``)."""
    vectors = getattr(code, "vectors", code)
    n_vec = len(vectors)
    max_len = max((v.vector_len for v in vectors), default=0)
    if pad_to is None:
        pad_to = max_len
    elif pad_to < max_len:
        raise ValueError(f"pad_to={pad_to} < max vector_len={max_len}")
    out = np.zeros((n_vec, pad_to), dtype=np.int8)
    if n_vec == 0:
        return out

    d_vals, _ = _grouped_escape_decode([v.deltas for v in vectors])
    reps = _grouped_rep_decode([v.reps for v in vectors])
    i_vals, i_esc = _grouped_escape_decode([v.indexes for v in vectors])

    # running weight values: segmented cumsum over Δ fields (the first
    # field of each vector carries the +128 bias, dummies are Δ=0)
    n_unique = np.array([v.n_unique for v in vectors], dtype=np.int64)
    cs = np.cumsum(d_vals)
    if len(cs):
        seg_first = np.cumsum(n_unique) - n_unique
        base = np.where(seg_first > 0, cs[np.maximum(seg_first - 1, 0)], 0)
        running = cs - np.repeat(base, n_unique) - 128
    else:                                    # all-zero layer: no uniques
        running = cs

    # absolute indexes from the Δ/absolute mix: every vector's first index
    # field is absolute, so a "reset at last escape" segmented cumsum
    # rebuilds all positions at once
    n_idx = np.array([v.indexes.count for v in vectors], dtype=np.int64)
    if len(i_vals):
        if not i_esc[0]:
            raise ValueError("corrupt index stream: first field not absolute")
        pos = np.arange(len(i_vals), dtype=np.int64)
        last_esc = np.maximum.accumulate(np.where(i_esc, pos, -1))
        ics = np.cumsum(np.where(i_esc, 0, i_vals))
        idx_abs = i_vals[last_esc] + ics - ics[last_esc]
    else:
        idx_abs = np.zeros(0, dtype=np.int64)

    w_vals = np.repeat(running, reps)
    row = np.repeat(np.arange(n_vec), n_idx)
    out[row, idx_abs] = w_vals.astype(np.int8)
    return out


def decode_layer_vectors(code) -> list[np.ndarray]:
    """Per-vector views of :func:`decode_layer`, each cropped to its own
    ``vector_len`` (a drop-in for a :func:`decode_vector` loop)."""
    padded = decode_layer(code)
    return [padded[i, : v.vector_len] for i, v in enumerate(code.vectors)]


def layer_params_search(ucr_vectors, vector_len: int) -> tuple[int, int, int]:
    """Per-layer, per-structure parameter search over ALL of a layer's
    vectors (§III-C: params are stored once per structure per layer)."""
    index_bits = max(1, math.ceil(math.log2(max(vector_len, 2))))
    all_deltas = np.concatenate(
        [delta_transform(u.unique_vals) for u in ucr_vectors]) \
        if ucr_vectors else np.zeros(0, dtype=np.int64)
    all_reps = np.concatenate([u.reps for u in ucr_vectors]) \
        if ucr_vectors else np.zeros(0, dtype=np.int64)
    all_idx = np.concatenate(
        [index_delta_fields(u.indexes)[0] for u in ucr_vectors]) \
        if ucr_vectors else np.zeros(0, dtype=np.int64)
    dp = search_delta_param(all_deltas)
    dcost = escape_stream_bits(all_deltas, dp, FULL_BITS) / max(len(all_deltas), 1)
    rp = search_rep_param(all_reps, dcost)
    ip = search_index_param(all_idx, index_bits)
    return dp, rp, ip


def layer_bits_size_only(ucr_vectors, vector_len: int,
                         params: tuple[int, int, int] | None = None) -> int:
    """Exact encoded size of a whole layer under shared per-layer params,
    without materializing a bitstream (the serving accounting).

    ``params`` — optional fixed (delta, rep, index) bit-lengths; ``None``
    runs :func:`layer_params_search` first.  Equal, bit for bit, to
    ``encode_conv_layer(...).total_bits`` under the same params."""
    if not ucr_vectors:
        return 3 * HEADER_BITS
    index_bits = max(1, math.ceil(math.log2(max(vector_len, 2))))
    if params is None:
        dp, rp, ip = layer_params_search(ucr_vectors, vector_len)
    else:
        dp, rp, ip = (int(p) for p in params)
    ip = min(ip, index_bits)
    all_deltas = np.concatenate(
        [delta_transform(u.unique_vals) for u in ucr_vectors])
    all_reps = np.concatenate([u.reps for u in ucr_vectors])
    all_idx = np.concatenate(
        [index_delta_fields(u.indexes)[0] for u in ucr_vectors])
    entries, dummy = split_rep_overflow(all_reps, rp)
    full_deltas = np.zeros(len(entries), dtype=np.int64)
    full_deltas[~dummy] = all_deltas
    return (escape_stream_bits(full_deltas, dp, FULL_BITS)
            + len(entries) * rp
            + escape_stream_bits(all_idx, ip, index_bits)
            + 3 * HEADER_BITS)


def encoded_bits_size_only(unique_vals: np.ndarray, reps: np.ndarray,
                           indexes: np.ndarray, vector_len: int) -> int:
    """Total bits of one vector encoded with its own searched params
    (:func:`encode_vector` with ``params=None``), without materializing
    a bitstream."""
    unique_vals = np.asarray(unique_vals, dtype=np.int64)
    reps = np.asarray(reps, dtype=np.int64)
    index_bits = max(1, math.ceil(math.log2(max(vector_len, 2))))
    base_deltas = delta_transform(unique_vals)
    delta_param = search_delta_param(base_deltas)
    delta_cost = escape_stream_bits(base_deltas, delta_param,
                                    FULL_BITS) / max(len(base_deltas), 1)
    rep_param = search_rep_param(reps, delta_cost)
    rep_entries, dummy = split_rep_overflow(reps, rep_param)
    full_deltas = np.zeros(len(rep_entries), dtype=np.int64)
    full_deltas[~dummy] = base_deltas
    idx_deltas, _ = index_delta_fields(indexes)
    index_param = search_index_param(idx_deltas, index_bits)
    return (escape_stream_bits(full_deltas, delta_param, FULL_BITS)
            + len(rep_entries) * rep_param
            + escape_stream_bits(idx_deltas, index_param, index_bits)
            + 3 * HEADER_BITS)
