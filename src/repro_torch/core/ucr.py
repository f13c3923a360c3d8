"""Universal Computation Reuse (paper §II-D) — the port's NumPy copy of
``repro.core.ucr``; encodings are byte-identical to the reference.

Offline pipeline, once per model:

  (i)   tile a conv layer into T_N input × T_M output channel tiles;
  (ii)  quantize weights to 8-bit fixed point;
  (iii) regroup the tile's weights per input channel into T_N vectors of
        length ``T_M * R_K * C_K``;
  (iv)  sort → densify (drop zeros) → unify (deduplicate);
  (v)   emit the Δs of the non-zero unique weights, per-repetition output
        indexes, and repetition counts, and hand them to the customized
        RLE encoders (:mod:`repro_torch.core.rle`).

A linear layer is a conv with R_K = C_K = 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import rle

__all__ = [
    "UCRVector", "ucr_transform", "ucr_reconstruct", "quantize_int8",
    "dequantize_int8", "restrict_unique", "encode_conv_layer", "encode_linear_layer",
    "LayerCode", "layer_ucr_vectors", "layer_code_size_only",
]


@dataclasses.dataclass
class UCRVector:
    """Sort/densify/unify decomposition of one weight vector."""

    unique_vals: np.ndarray   # sorted ascending non-zero unique int8 values
    reps: np.ndarray          # repetition count per unique value
    indexes: np.ndarray       # flat per-repetition positions (ascending per group)
    vector_len: int

    @property
    def n_nonzero(self) -> int:
        return int(self.reps.sum())

    @property
    def density(self) -> float:
        return self.n_nonzero / max(self.vector_len, 1)


def ucr_transform(w: np.ndarray) -> UCRVector:
    """Sort, densify, and unify an int8 weight vector (paper Fig. 1 e/g/h)."""
    w = np.asarray(w).reshape(-1)
    nz = np.nonzero(w)[0]
    vals = w[nz].astype(np.int64)
    unique_vals, inverse, reps = np.unique(vals, return_inverse=True,
                                           return_counts=True)
    # positions nz are ascending, so a stable sort on the unique id keeps
    # each unique value's positions ascending
    order = np.argsort(inverse, kind="stable")
    indexes = nz[order]
    return UCRVector(unique_vals, reps, indexes, int(w.size))


def ucr_reconstruct(u: UCRVector) -> np.ndarray:
    """Inverse transform — rebuilds the dense int8 vector."""
    w = np.zeros(u.vector_len, dtype=np.int8)
    cursor = 0
    for val, rep in zip(u.unique_vals, u.reps):
        idx = u.indexes[cursor : cursor + int(rep)]
        w[idx] = val
        cursor += int(rep)
    return w


# ---------------------------------------------------------------------------
# quantization (paper step ii — 8-bit fixed point, symmetric)
# ---------------------------------------------------------------------------

def quantize_int8(w: np.ndarray, *, per_channel_axis: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization: ``(q, scale)`` with ``w ≈ q * scale``.
    Per tensor ``scale`` is a float32 0-d array; with ``per_channel_axis``
    it is float32 with ``w``'s rank (keepdims), one scale per index of
    that axis."""
    w = np.asarray(w, dtype=np.float32)
    if per_channel_axis is None:
        amax = np.abs(w).max()
        scale = np.float32(amax / 127.0 if amax > 0 else 1.0)
        q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        return q, np.asarray(scale)
    axes = tuple(i for i in range(w.ndim) if i != per_channel_axis)
    amax = np.abs(w).max(axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


def restrict_unique(q: np.ndarray, n_unique: int) -> np.ndarray:
    """Limit an int8 tensor to ``n_unique`` levels TOTAL including zero
    (the paper's U knob): uniform re-quantization of the int8 grid,
    keeping 0 exactly 0."""
    if n_unique >= 256:
        return q
    step = -(-256 // (n_unique - 1))           # ceil → ≤ n_unique-1 nonzero
    out = (q.astype(np.int32) + 128) // step * step - 128 + step // 2
    out = np.where(q == 0, 0, np.clip(out, -127, 127))
    return out.astype(np.int8)


# ---------------------------------------------------------------------------
# whole-layer encoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCode:
    """CoDR code for one layer: one EncodedVector per (tile, input channel).

    ``shape`` is the original weight shape — ``(M, N, R_K, C_K)`` for conv,
    ``(M, N)`` for linear.  Encoding parameters are shared per layer per
    structure (paper §III-C) and counted once in ``total_bits``.
    """

    vectors: list[rle.EncodedVector]
    ucr: list[UCRVector]
    shape: tuple[int, ...]
    scale: np.ndarray
    t_m: int
    t_n: int
    params: tuple[int, int, int] = (4, 4, 4)

    @property
    def total_bits(self) -> int:
        payload = sum(v.deltas.nbits + v.reps.nbits + v.indexes.nbits
                      for v in self.vectors)
        return payload + 3 * rle.HEADER_BITS

    @property
    def n_weights(self) -> int:
        return int(np.prod(self.shape))

    @property
    def bits_per_weight(self) -> float:
        return self.total_bits / max(self.n_weights, 1)


def _iter_tile_vectors(q: np.ndarray, t_m: int, t_n: int):
    """Yield the vector of every (output-tile, input-channel) pair, tile
    major.  ``q`` is ``(M, N, R_K, C_K)`` int8."""
    m, n = q.shape[0], q.shape[1]
    kernel = int(np.prod(q.shape[2:])) if q.ndim > 2 else 1
    qr = q.reshape(m, n, kernel)
    for m0 in range(0, m, t_m):
        tile_m = qr[m0 : m0 + t_m]                    # (tm, N, K)
        for n0 in range(0, n, t_n):
            for nn in range(n0, min(n0 + t_n, n)):
                yield tile_m[:, nn, :].reshape(-1)    # length tm*K


def encode_conv_layer(w: np.ndarray, *, t_m: int = 4, t_n: int = 4,
                      n_unique: int = 256,
                      params: tuple[int, int, int] | None = None) -> LayerCode:
    """Full offline pipeline for a conv weight ``(M, N, R_K, C_K)`` (float).

    ``n_unique`` — the paper's U knob (Fig. 6); ``params`` — optional
    fixed (delta, rep, index) RLE bit-lengths, ``None`` runs the
    per-layer, per-structure search of §III-C.
    """
    q, scale = quantize_int8(w)
    if n_unique < 256:
        q = restrict_unique(q, n_unique)
    ucrs = [ucr_transform(vec) for vec in _iter_tile_vectors(q, t_m, t_n)]
    vector_len = max((u.vector_len for u in ucrs), default=2)
    if params is None:
        params = rle.layer_params_search(ucrs, vector_len)
    else:
        params = tuple(int(p) for p in params)
        if len(params) != 3 or any(p < 1 for p in params):
            raise ValueError(f"rle params must be 3 positive bit-lengths, "
                             f"got {params}")
    vectors = [rle.encode_vector(u.unique_vals, u.reps, u.indexes,
                                 u.vector_len, params=params)
               for u in ucrs]
    return LayerCode(vectors, ucrs, tuple(w.shape), scale, t_m, t_n, params)


def encode_linear_layer(w: np.ndarray, *, t_m: int = 256, t_n: int = 1,
                        n_unique: int = 256,
                        params: tuple[int, int, int] | None = None
                        ) -> LayerCode:
    """Linear layer ``(M, N)`` = conv with a 1×1 kernel."""
    return encode_conv_layer(np.asarray(w)[:, :, None, None], t_m=t_m,
                             t_n=t_n, n_unique=n_unique, params=params)


def layer_ucr_vectors(q: np.ndarray, *, t_m: int = 4, t_n: int = 4
                      ) -> list[UCRVector]:
    """UCR vectors of an int8 layer under a tile geometry — the
    sort/densify/unify half of the pipeline without any RLE bitstream.
    The tuner (:mod:`repro_torch.tune`) scores candidate tile geometries
    with this + :func:`repro_torch.core.rle.layer_bits_size_only`."""
    q = np.asarray(q)
    if q.ndim == 2:
        q = q[:, :, None, None]
    return [ucr_transform(vec) for vec in _iter_tile_vectors(q, t_m, t_n)]


def layer_code_size_only(w: np.ndarray, *, t_m: int = 4, t_n: int = 4,
                         n_unique: int = 256,
                         params: tuple[int, int, int] | None = None
                         ) -> tuple[int, int]:
    """Fast path: (total encoded bits, total weights) without bitstreams.

    Accepts the same U budget / fixed-RLE-params knobs as
    :func:`encode_conv_layer` so size predictions and real encodes agree.
    """
    q, _ = quantize_int8(w)
    if n_unique < 256:
        q = restrict_unique(q, n_unique)
    ucrs = layer_ucr_vectors(q, t_m=t_m, t_n=t_n)
    vector_len = max((u.vector_len for u in ucrs), default=2)
    return (rle.layer_bits_size_only(ucrs, vector_len, params=params),
            int(np.prod(q.shape)))
