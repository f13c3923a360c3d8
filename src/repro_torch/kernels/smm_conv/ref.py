"""Plain PyTorch versions of the SMM convolution.

* :func:`smm_conv_plain` — the kernel's own function on its packed
  operands ``(x, deltas, entries)``: what the CUDA kernel computes, in
  ordinary tensor ops.  The CPU path of :mod:`.ops` and the yardstick the
  kernel is held to on the card.
* :func:`smm_conv_ref` — the dense oracle of ``repro.kernels.smm_conv.ref``:
  a convolution of the weights rebuilt from the UCR vectors.

Both rebuild dense integer weights and convolve tap by tap in float64:
every product and partial sum is an integer below 2^53, so the result is
exact in any summation order and equals the int64 ``smm`` lane; it is
cast to float32 at the end, as the kernel casts its int32 accumulators.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ucr import LayerCode, ucr_reconstruct

__all__ = ["decode_dense_weights", "smm_conv_plain", "smm_conv_ref"]


def decode_dense_weights(code: LayerCode, n_in: int) -> np.ndarray:
    """Rebuild the dense int8 weight tensor (M, N, RK, CK) from UCR vectors."""
    m = code.shape[0]
    rk, ck = (code.shape[2], code.shape[3]) if len(code.shape) == 4 else (1, 1)
    m_tiles = -(-m // code.t_m)
    w = np.zeros((m_tiles * code.t_m, n_in, rk, ck), dtype=np.int8)
    for vi, u in enumerate(code.ucr):
        mt, nn = vi // n_in, vi % n_in
        vec = ucr_reconstruct(u).reshape(-1, rk, ck)   # (t_m, rk, ck)
        w[mt * code.t_m : mt * code.t_m + vec.shape[0], nn] = vec
    return w[:m]


def _tap_conv(x: torch.Tensor, w: torch.Tensor, stride: int, ro: int,
              co: int) -> torch.Tensor:
    """VALID strided conv of ``x`` (B, N, RI, CI) with ``w`` (M, N, KH, KW),
    one matmul per kernel tap, in float64 (exact on integers < 2^53)."""
    x = x.to(torch.float64)
    w = w.to(torch.float64)
    out = torch.zeros(x.shape[0], w.shape[0], ro, co, dtype=torch.float64,
                      device=x.device)
    for r in range(w.shape[2]):
        for c in range(w.shape[3]):
            win = x[:, :, r : r + stride * (ro - 1) + 1 : stride,
                    c : c + stride * (co - 1) + 1 : stride]
            out += torch.einsum("mn,bnhw->bmhw", w[:, :, r, c], win)
    return out


def smm_conv_plain(x: torch.Tensor, deltas: torch.Tensor,
                   entries: torch.Tensor, *, t_m: int, ro: int, co: int,
                   stride: int = 1) -> torch.Tensor:
    """``x`` (B, N, RI, CI) f32 → (B, m_tiles·t_m, RO, CO) f32, the
    function of the ``smm_conv`` kernel on its packed operands.

    Each entry (u, m_local, r, c) of vector (m_tile, n) routes the window
    of value[u]·x[:, n] at tap (r, c) into channel m_tile·t_m + m_local,
    where value is the running sum of that vector's Δs and value[U] = 0
    (the zero product row that padding entries point at)."""
    b, n_in, ri, ci = x.shape
    m_tiles, _, u_plus = deltas.shape
    vals = torch.cumsum(deltas.to(torch.float64), dim=-1)
    vals[..., u_plus - 1] = 0
    u, m_loc, r, c = entries.to(torch.long).unbind(-1)   # (m_tiles, N, L)
    mt = torch.arange(m_tiles, device=x.device)[:, None, None].expand_as(u)
    nn = torch.arange(n_in, device=x.device)[None, :, None].expand_as(u)
    kh, kw = ri - (ro - 1) * stride, ci - (co - 1) * stride
    w = torch.zeros(m_tiles, t_m, n_in, kh, kw, dtype=torch.float64,
                    device=x.device)
    w.index_put_((mt, m_loc, nn, r, c), torch.gather(vals, 2, u),
                 accumulate=True)
    w = w.reshape(m_tiles * t_m, n_in, kh, kw)
    return _tap_conv(x, w, stride, ro, co).to(torch.float32)


def smm_conv_ref(x, code: LayerCode, stride: int = 1) -> torch.Tensor:
    """Dense oracle: ``x`` (N, RI, CI) → (M, RO, CO) float32, the
    convolution of the decoded weights."""
    x = torch.as_tensor(x)[None]
    n_in, ri, ci = x.shape[1:]
    w = torch.from_numpy(decode_dense_weights(code, n_in))
    ro = (ri - w.shape[2]) // stride + 1
    co = (ci - w.shape[3]) // stride + 1
    return _tap_conv(x, w, stride, ro, co)[0].to(torch.float32)
