"""Scalar–matrix multiplication dataflow (paper §III-A, Fig. 3b) with
differential computation (paper Eq. 1) — the NumPy ``smm`` lane, the
port's copy of ``repro.core.smm``.

The faithful execution model of a CoDR processing unit: each unique
weight (reconstructed by the running Δ-sum — the differential
accumulator) multiplies the whole input-feature matrix once, and every
repetition index routes a window of that product to its output
accumulator (the MPE→crossbar→APE path).  Bit-exact in int64; the oracle
the CUDA ``smm_conv`` kernel is held to.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ucr import LayerCode, UCRVector

__all__ = ["conv2d_smm", "conv2d_smm_batched", "linear_smm",
           "conv2d_dense_ref", "decode_index", "smm_op_counts"]


def decode_index(flat_idx, kernel_shape: tuple[int, int]):
    """A flat index in a UCR vector of length ``T_M*R_K*C_K`` encodes the
    (output-channel-within-tile, kernel-row, kernel-col) coordinate.
    Works elementwise on integer arrays too."""
    rk, ck = kernel_shape
    m = flat_idx // (rk * ck)
    rem = flat_idx % (rk * ck)
    return m, rem // ck, rem % ck


def conv2d_dense_ref(x: np.ndarray, w: np.ndarray, stride: int = 1) -> np.ndarray:
    """Dense integer conv oracle: ``x`` (N, R_I, C_I) int, ``w``
    (M, N, R_K, C_K) int → int64 (M, RO, CO)."""
    n, ri, ci = x.shape
    m, n2, rk, ck = w.shape
    assert n == n2
    ro, co = (ri - rk) // stride + 1, (ci - ck) // stride + 1
    out = np.zeros((m, ro, co), dtype=np.int64)
    for mm in range(m):
        for nn in range(n):
            for r in range(rk):
                for c in range(ck):
                    out[mm] += (w[mm, nn, r, c].astype(np.int64)
                                * x[nn, r : r + stride * ro : stride,
                                     c : c + stride * co : stride])
    return out


def conv2d_smm(x: np.ndarray, code: LayerCode, stride: int = 1) -> np.ndarray:
    """CoDR execution of one sample ``x`` (N, R_I, C_I) → int64
    (M, RO, CO), identical to a dense integer conv."""
    return conv2d_smm_batched(x[None], code, stride)[0]


def conv2d_smm_batched(x: np.ndarray, code: LayerCode,
                       stride: int = 1) -> np.ndarray:
    """Batched CoDR execution: ``x`` (B, N, R_I, C_I) → int64
    (B, M, RO, CO); every scalar–matrix product and routed window
    broadcasts over the batch axis."""
    x = np.asarray(x)
    m, n = code.shape[0], code.shape[1]
    rk, ck = (code.shape[2], code.shape[3]) if len(code.shape) == 4 else (1, 1)
    b, _, ri, ci = x.shape
    ro, co = (ri - rk) // stride + 1, (ci - ck) // stride + 1
    out = np.zeros((b, m, ro, co), dtype=np.int64)

    vec_iter = iter(code.ucr)
    n_tiles_n = -(-n // code.t_n)
    for m0 in range(0, m, code.t_m):
        for n0idx in range(n_tiles_n):
            n0 = n0idx * code.t_n
            for nn in range(n0, min(n0 + code.t_n, n)):
                _smm_one_vector(out, x[:, nn], next(vec_iter), m0, (rk, ck),
                                ro, co, stride)
    return out


def _smm_one_vector(out, x_planes, u: UCRVector, m0, kshape, ro, co, stride):
    """One MPE pass: running Δ-sum over unique weights; scalar × matrix;
    per-repetition window routed to APE ``m0 + m_local``."""
    running = np.int64(0)
    cursor = 0
    x_planes = x_planes.astype(np.int64)
    prev_product = None
    for val, rep in zip(u.unique_vals, u.reps):
        delta = np.int64(val) - running
        running += delta
        # differential computation (Eq. 1): Δ × I + previous product
        if prev_product is None:
            product = running * x_planes
        else:
            product = delta * x_planes + prev_product
        prev_product = product
        for idx in u.indexes[cursor : cursor + int(rep)]:
            m_local, r, c = decode_index(int(idx), kshape)
            out[:, m0 + m_local] += product[:, r : r + stride * ro : stride,
                                            c : c + stride * co : stride]
        cursor += int(rep)


def linear_smm(x: np.ndarray, code: LayerCode) -> np.ndarray:
    """FC layer via SMM (paper Fig. 1 model): per input unit, the weight
    column's unique values each multiply the input scalar once (by the
    running Δ-sum); indexes route the products to output accumulators.
    ``x`` (N,) int → int64 (M,)."""
    m, n = code.shape[0], code.shape[1]
    out = np.zeros(m, dtype=np.int64)
    vec_iter = iter(code.ucr)
    for m0 in range(0, m, code.t_m):
        for n0 in range(0, n, code.t_n):
            for nn in range(n0, min(n0 + code.t_n, n)):
                u = next(vec_iter)
                running = np.int64(0)
                cursor = 0
                xi = np.int64(x[nn])
                prev = np.int64(0)
                for val, rep in zip(u.unique_vals, u.reps):
                    delta = np.int64(val) - running
                    running += delta
                    prev = delta * xi + prev
                    for idx in u.indexes[cursor : cursor + int(rep)]:
                        out[m0 + int(idx)] += prev
                    cursor += int(rep)
    return out


def smm_op_counts(code: LayerCode, feature_elems: int) -> dict:
    """Multiply / accumulate counts under UCR — the paper's ALU story:
    multiplies scale with unique weights, not with all weights.
    ``feature_elems`` is the size of the feature matrix each weight
    multiplies (one output plane for a conv)."""
    n_unique = sum(len(u.unique_vals) for u in code.ucr)
    n_nonzero = sum(u.n_nonzero for u in code.ucr)
    return {
        "mults": n_unique * feature_elems,
        "accums": n_nonzero * feature_elems,
        "dense_mults": code.n_weights * feature_elems,
        "unique_ratio": n_unique / max(n_nonzero, 1),
        "density": n_nonzero / max(code.n_weights, 1),
    }
