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

__all__ = ["decode_index", "conv2d_smm", "conv2d_smm_batched"]


def decode_index(flat_idx, kernel_shape: tuple[int, int]):
    """A flat index in a UCR vector of length ``T_M*R_K*C_K`` encodes the
    (output-channel-within-tile, kernel-row, kernel-col) coordinate.
    Works elementwise on integer arrays too."""
    rk, ck = kernel_shape
    m = flat_idx // (rk * ck)
    rem = flat_idx % (rk * ck)
    return m, rem // ck, rem % ck


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
